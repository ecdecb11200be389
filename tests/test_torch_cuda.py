"""The CUDA kernels and the engine on the card (marked ``cuda``).

Each kernel is held against its plain version (``kernels/ref.py``) on the
same CUDA tensors: ``paa_isax`` and the three lower bounds bit for bit,
``euclid_sq`` and ``euclid_min`` within 1e-5 relative (they sum in another
order; ``euclid_min``'s row is the plain argmin or a row at a distance
within 1e-5 of it). The engines on the card are held against the same
engines on the CPU. Whether a
card is present is decided inside the ``cuda_device`` fixture, so every
worker collects the same tests; without a card they skip with a reason.
This file imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import isax as tx
from repro_torch.core.datagen import random_walk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 16])
def test_cuda_paa_isax_matches_plain(cuda_device, w):
    z = tx.znorm(_t(random_walk(5000, 256, seed=71))).to(cuda_device)
    bp = tx.gaussian_breakpoints(256, cuda_device)
    k_sax, k_paa = tops.paa_isax(z, bp, w, normalize=False)
    p_sax, p_paa = tops.paa_isax(z, bp, w, normalize=False, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(k_paa, p_paa) and torch.equal(k_sax, p_sax)
    raw = _t(random_walk(5000, 256, seed=72)).to(cuda_device)
    k_sax, k_paa = tops.paa_isax(raw, bp, w, normalize=True)
    p_sax, p_paa = tops.paa_isax(raw, bp, w, normalize=True, impl="ref")
    torch.testing.assert_close(k_paa, p_paa, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_cuda_lower_bound_batch_bitwise(cuda_device, w):
    z = tx.znorm(_t(random_walk(3000, 256, seed=81))).to(cuda_device)
    q = tx.znorm(_t(random_walk(70, 256, seed=82))).to(cuda_device)  # > one query block
    sax, _ = tx.convert_to_sax(z, w, 256, normalize=False)
    qp = tx.paa(q, w)
    bpp = tx.padded_breakpoints(256, cuda_device)
    got = tops.lower_bound_sq_batch(qp, sax, bpp, 256)
    want = tops.lower_bound_sq_batch(qp, sax, bpp, 256, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 256, 100])  # 100: the scalar-load path
def test_cuda_euclid_gather_matches_plain(cuda_device, n):
    raw = _t(random_walk(2000, n, seed=91)).to(cuda_device)
    qs = _t(random_walk(9, n, seed=92)).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pos = torch.randint(-3, 2003, (9, 333), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    for p in (pos, pos[0].contiguous()):
        got = tops.euclid_sq_gather(qs, raw, p)
        want = tops.euclid_sq_gather(qs, raw, p, impl="ref")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(cuda_device):
    from repro_torch.core import Tier, build_index
    from repro_torch.core.search import exact_knn_batch, knn_batch_tiered

    raw = random_walk(6000, 128, seed=101)
    queries = random_walk(8, 128, seed=102)
    tops.reset_launch_counts()
    on_card = build_index(raw, device=cuda_device)
    on_cpu = build_index(raw, device="cpu")
    assert torch.equal(on_card.sax.cpu(), on_cpu.sax)
    assert torch.equal(on_card.pos.cpu(), on_cpu.pos)
    for k in (1, 8):
        d, p = exact_knn_batch(on_card, queries, k=k, round_size=256)
        d0, p0 = exact_knn_batch(on_cpu, queries, k=k, round_size=256)
        torch.testing.assert_close(d.cpu(), d0, rtol=1e-5, atol=1e-5)
        _, _, ach = knn_batch_tiered(on_card, queries, Tier.epsilon(0.1), k=k,
                                     round_size=256)
        assert np.all(ach <= 0.1 + 1e-6)
    counts = tops.launch_counts()  # the main path's kernels
    for name in ("paa_isax", "lower_bound_sq_batch", "euclid_sq",
                 "engine_round"):
        assert counts[name] > 0, counts


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_input(cuda_device):
    from repro_torch.kernels import lower_bound

    sax = torch.zeros((10, 12), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="w=12"):
        lower_bound.lower_bound_sq_batch_cuda(
            torch.zeros((2, 12), device=cuda_device), sax,
            tx.padded_breakpoints(256, cuda_device), 48)
    with pytest.raises(ValueError, match="float32"):
        tops.paa_isax(torch.zeros((4, 64), dtype=torch.float64,
                                  device=cuda_device),
                      tx.gaussian_breakpoints(256, cuda_device), 16)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 16])
def test_cuda_lower_bound_single_bitwise(cuda_device, w):
    z = tx.znorm(_t(random_walk(5001, 256, seed=111))).to(cuda_device)
    q = tx.znorm(_t(random_walk(1, 256, seed=112))).to(cuda_device)[0]
    sax, _ = tx.convert_to_sax(z, w, 256, normalize=False)
    qp = tx.paa(q, w)
    bpp = tx.padded_breakpoints(256, cuda_device)
    want = tops.lower_bound_sq(qp, sax, bpp, 256, impl="ref")
    for transposed in (False, True):
        got = tops.lower_bound_sq(qp, sax, bpp, 256, transposed=transposed)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _packed_on(dev, w):
    # Three components of 300, 77 and 130 rows in blocks of 128 (pad rows
    # between them) and a dead tail block (block_len == 0).
    sizes, block = (300, 77, 130), 128
    z = tx.znorm(_t(random_walk(sum(sizes), 256, seed=121))).to(dev)
    sax, _ = tx.convert_to_sax(z, w, 256, normalize=False)
    parts, lens, start = [], [], 0
    for m in sizes:
        pad = (-m) % block
        parts += [sax[start:start + m],
                  torch.zeros((pad, w), dtype=torch.uint8, device=dev)]
        blk = [block] * ((m + pad) // block)
        blk[-1] = block - pad
        lens += blk
        start += m
    parts.append(torch.full((block, w), 7, dtype=torch.uint8, device=dev))
    lens.append(0)
    return (torch.cat(parts),
            torch.tensor(lens, dtype=torch.int32, device=dev), block)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 16])
def test_cuda_lower_bound_multi_bitwise(cuda_device, w):
    sax, block_len, block = _packed_on(cuda_device, w)
    q = tx.znorm(_t(random_walk(70, 256, seed=122))).to(cuda_device)
    qp = tx.paa(q, w)
    bpp = tx.padded_breakpoints(256, cuda_device)
    got = tops.lower_bound_sq_multi(qp, sax, bpp, 256, block_len,
                                    block_n=block)
    want = tops.lower_bound_sq_multi(qp, sax, bpp, 256, block_len,
                                     block_n=block, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    real = (torch.arange(block, device=cuda_device)[None, :]
            < block_len[:, None]).reshape(-1)
    assert torch.isinf(got[:, ~real]).all() and torch.isfinite(got[:, real]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(70001, 64), (5000, 256), (3000, 100)])
def test_cuda_euclid_min_first_index_on_ties(cuda_device, rows, n):
    # 70001 rows outgrow one pass of the grid (its blocks stride); n = 100
    # takes the scalar-load path.
    data = _t(random_walk(rows, n, seed=131)).to(cuda_device)
    data[rows - 5] = data[rows // 3]  # an exact tie of the nearest row
    q = data[rows // 3] + 0.01
    d, i = tops.euclid_min(q, data)
    pd, pi = tops.euclid_min(q, data, impl="ref")
    torch.cuda.synchronize()
    assert i.dtype == torch.int32 and int(i) == int(pi) == rows // 3
    torch.testing.assert_close(d, pd, rtol=1e-5, atol=1e-6)
    tops.reset_launch_counts()
    tops.euclid_min(q, data)
    assert tops.launch_counts()["euclid_min"] == 1


@pytest.mark.cuda
def test_cuda_new_wrappers_reject_bad_input(cuda_device):
    from repro_torch.kernels import euclidean, lower_bound

    bpp = tx.padded_breakpoints(256, cuda_device)
    sax = torch.zeros((256, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        lower_bound.lower_bound_sq_cuda(
            torch.zeros(16, dtype=torch.float64, device=cuda_device), sax,
            bpp, 256)
    with pytest.raises(ValueError, match="block_len has"):
        lower_bound.lower_bound_sq_multi_cuda(
            torch.zeros((2, 16), device=cuda_device), sax, bpp, 256,
            torch.ones(3, dtype=torch.int32, device=cuda_device), 128)
    with pytest.raises(ValueError, match="int32"):
        lower_bound.lower_bound_sq_multi_cuda(
            torch.zeros((2, 16), device=cuda_device), sax, bpp, 256,
            torch.ones(2, dtype=torch.int64, device=cuda_device), 128)
    data = torch.zeros((10, 64), device=cuda_device)
    with pytest.raises(ValueError, match="n=32"):
        euclidean.euclid_min_cuda(torch.zeros(32, device=cuda_device), data)
    with pytest.raises(ValueError, match="contiguous"):
        euclidean.euclid_min_cuda(torch.zeros(10, device=cuda_device),
                                  data[:, :10])


@pytest.mark.cuda
def test_cuda_baselines_match_cpu(cuda_device):
    from repro_torch.core import SearchConfig, build_index
    from repro_torch.core.search import (brute_force, exact_search_single,
                                         nb_exact_search)

    raw = random_walk(6000, 128, seed=141)
    queries = random_walk(4, 128, seed=142)
    on_card = build_index(raw, device=cuda_device)
    on_cpu = build_index(raw, device="cpu")
    cfg = SearchConfig(round_size=256, workers=4)
    tops.reset_launch_counts()
    for q in queries:
        for fn in (exact_search_single, nb_exact_search):
            a, b = fn(on_card, q, cfg), fn(on_cpu, q, cfg)
            assert int(a.position) == int(b.position)
            assert a.rounds == b.rounds
            torch.testing.assert_close(a.dist_sq.cpu(), b.dist_sq,
                                       rtol=1e-5, atol=1e-5)
        a, b = brute_force(on_card, q), brute_force(on_cpu, q)
        assert int(a.position) == int(b.position)
        torch.testing.assert_close(a.dist_sq.cpu(), b.dist_sq, rtol=1e-5,
                                   atol=1e-5)
    counts = tops.launch_counts()
    assert counts["lower_bound_sq"] == 8 and counts["euclid_min"] == 4
    assert counts["euclid_sq"] > 0


@pytest.mark.cuda
def test_cuda_packed_engine_matches_cpu(cuda_device):
    from repro_torch.core import Tier, build_index
    from repro_torch.core.search import (exact_knn_batch,
                                         exact_knn_batch_packed,
                                         knn_batch_packed_tiered,
                                         pack_components, packed_seed)

    raw = random_walk(6000, 128, seed=151)
    queries = random_walk(8, 128, seed=152)
    cuts = (0, 2900, 4500, 6000)  # no size a multiple of the block
    answers = {}
    for dev in (cuda_device, torch.device("cpu")):
        comps = [(build_index(raw[a:b], device=dev), a)
                 for a, b in zip(cuts[:-1], cuts[1:])]
        packed = pack_components(comps)
        tops.reset_launch_counts()
        d, p = exact_knn_batch_packed(packed, queries, k=8, round_size=256)
        de, pe, ach = knn_batch_packed_tiered(
            packed, queries, Tier.epsilon(0.1), k=8, round_size=256,
            seed=packed_seed(comps, queries))
        answers[dev.type] = (d.cpu(), p.cpu(), tops.launch_counts())
        assert (ach <= 0.1 + 1e-6).all()
        assert torch.all(de.sqrt() <= 1.1 * d.sqrt() * (1 + 1e-5))
    (d, p, counts), (d0, p0, _) = answers["cuda"], answers["cpu"]
    assert torch.equal(p, p0)
    torch.testing.assert_close(d, d0, rtol=1e-5, atol=1e-5)
    assert counts["lower_bound_sq_multi"] == 2 and counts["euclid_sq"] > 0
    single = build_index(raw, device=cuda_device)
    d1, p1 = exact_knn_batch(single, queries, k=8, round_size=256)
    assert torch.equal(p1.cpu(), p) and torch.equal(d1.cpu(), d)


# The batch lower-bound kernel gives each thread 4 rows (2 at w = 32) of a
# 128-thread block, a tile of 512 rows (256 at w = 32). These N run one
# below, at and one above both tiles, and a large odd N.
EDGE_ROWS = (255, 256, 257, 511, 512, 513, 100_003)


def _edge_inputs(dev, n_q, rows, w, seed, card=256):
    # SAX rows of every symbol, with 0 and card - 1 forced on some rows so
    # the +/-BIG pads bound them; query PAAs on breakpoints, on their float
    # neighbours, at +/-0.0 and at +/-BIG.
    rng = np.random.default_rng(seed)
    bp = tx.padded_breakpoints(card).numpy()
    pool = np.concatenate([bp, np.nextafter(bp, np.float32(np.inf)),
                           np.nextafter(bp, np.float32(-np.inf)),
                           np.float32([0.0, -0.0]),
                           rng.standard_normal(64).astype(np.float32)])
    qp = rng.choice(pool, size=(n_q, w)).astype(np.float32)
    sax = rng.integers(0, card, size=(rows, w), dtype=np.uint8)
    sax[::5], sax[2::5] = 0, card - 1
    return (_t(qp).to(dev), _t(sax).to(dev),
            tx.padded_breakpoints(card, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_cuda_lower_bound_batch_edges_bitwise(cuda_device, w, n_q):
    for rows in EDGE_ROWS:
        qp, sax, bpp = _edge_inputs(cuda_device, n_q, rows, w, rows + n_q)
        got = tops.lower_bound_sq_batch(qp, sax, bpp, 256)
        want = tops.lower_bound_sq_batch(qp, sax, bpp, 256, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want), rows


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_cuda_lower_bound_multi_edges_bitwise(cuda_device, w, n_q):
    # N_pad of 896, 99,968 and 1,300 rows: none a multiple of the tile.
    rng = np.random.default_rng(1000 * w + n_q)
    for block, n_blocks in ((128, 7), (128, 781), (100, 13)):
        lens = rng.choice([0, block, 1, block - 1, block // 2], n_blocks)
        lens[:3] = (0, block, block // 2)  # dead, full and partial blocks
        block_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        qp, sax, bpp = _edge_inputs(cuda_device, n_q, block * n_blocks, w,
                                    block + n_blocks)
        got = tops.lower_bound_sq_multi(qp, sax, bpp, 256, block_len,
                                        block_n=block)
        want = tops.lower_bound_sq_multi(qp, sax, bpp, 256, block_len,
                                         block_n=block, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want), (block, n_blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_cuda_lower_bound_single_edges_bitwise(cuda_device, w):
    for rows in EDGE_ROWS:
        qp, sax, bpp = _edge_inputs(cuda_device, 1, rows, w, rows)
        want = tops.lower_bound_sq(qp[0], sax, bpp, 256, impl="ref")
        for transposed in (False, True):
            got = tops.lower_bound_sq(qp[0], sax, bpp, 256,
                                      transposed=transposed)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (rows, transposed)


# The single-query kernel walks the rows in a persistent grid (as many
# 512-row tiles at once as the card holds, 270,336 rows at w = 16 on an
# H100) with one copy of the breakpoint table per lane, filled from the n_bpp
# entries given. These N take several passes of the grid, or less than one
# tile.
SINGLE_ROWS = (1, 31, 33, 1_000_003, 2**21 + 5)


def _single_bitwise(qp, sax, bpp):
    want = tops.lower_bound_sq(qp, sax, bpp, 256, impl="ref")
    for transposed in (False, True):
        got = tops.lower_bound_sq(qp, sax, bpp, 256, transposed=transposed)
        torch.cuda.synchronize()
        assert torch.equal(got, want), transposed


@pytest.mark.cuda
@pytest.mark.parametrize("card", [2, 16, 64, 128])  # n_bpp < 257
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_cuda_lower_bound_single_cardinalities_bitwise(cuda_device, w, card):
    qp, sax, bpp = _edge_inputs(cuda_device, 1, 5003, w, card + w, card=card)
    _single_bitwise(qp[0], sax, bpp)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", SINGLE_ROWS)
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_cuda_lower_bound_single_grid_passes_bitwise(cuda_device, w, rows):
    qp, sax, bpp = _edge_inputs(cuda_device, 1, rows, w, rows + w)
    _single_bitwise(qp[0], sax, bpp)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["broadcast", "one_bank", "every_symbol"])
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_cuda_lower_bound_single_symbol_patterns_bitwise(cuda_device, w,
                                                         pattern):
    # A warp's 32 rows are its 32 lanes. broadcast: all lanes of a warp on
    # one symbol (a new one each warp and column); one_bank: symbols 32k,
    # the same bank of a single shared table; every_symbol: row r takes
    # symbol (r + j) % 256 in column j.
    rows = 70_003
    qp, _, bpp = _edge_inputs(cuda_device, 1, rows, w, w)
    r = torch.arange(rows, device=cuda_device)[:, None]
    j = torch.arange(w, device=cuda_device)[None, :]
    sym = {"broadcast": (r // 32 * 7 + j) % 256,
           "one_bank": (r * 3 + j) % 8 * 32,
           "every_symbol": (r + j) % 256}[pattern]
    _single_bitwise(qp[0], sym.to(torch.uint8).contiguous(), bpp)


@pytest.mark.cuda
def test_cuda_tier_arrays_default_to_the_card(cuda_device):
    from repro_torch.core.search import Tier, tier_arrays

    fac, bud = tier_arrays([Tier.epsilon(0.5), Tier.budget(3)])
    assert fac.device.type == bud.device.type == "cuda"


# --- The disk path: pipelined build, live durable store, cold tier. ---


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paris+", "paris", "serial"])
def test_cuda_pipeline_matches_build_index_and_cpu(cuda_device, tmp_path,
                                                   mode):
    from repro_torch.core import PipelineBuilder, SeriesSource, build_index

    raw = random_walk(6000, 128, seed=161)
    src = SeriesSource.from_array(raw, chunk_series=700)
    tops.reset_launch_counts()
    on_card, stats = PipelineBuilder(
        mode=mode, n_workers=3, mem_limit_series=1500,
        workdir=str(tmp_path / "card"), device=cuda_device).build(src)
    # three workers launch at once; the count is exact
    assert tops.launch_counts()["paa_isax"] == src.num_chunks
    assert stats.epochs == 3 and stats.chunks == src.num_chunks
    one_shot = build_index(raw, device=cuda_device)
    on_cpu, _ = PipelineBuilder(
        mode=mode, mem_limit_series=1500, workdir=str(tmp_path / "cpu"),
        device="cpu").build(src)
    for name in ("sax", "pos", "bucket_offsets", "raw"):
        assert torch.equal(getattr(on_card, name), getattr(one_shot, name))
        assert torch.equal(getattr(on_card, name).cpu(),
                           getattr(on_cpu, name)), name
    for epoch in ("e0", "e1", "e2"):
        for name in ("keys.npy", "sax.npy", "pos.npy"):
            assert ((tmp_path / "card" / epoch / name).read_bytes()
                    == (tmp_path / "cpu" / epoch / name).read_bytes())


def _live_answers(dev, workdir, raw, queries):
    """One durable store's answers along appends, folds, recovery and
    demotion; with the launch counts of the live phase."""
    from repro_torch.core import (CompactionPolicy, IngestPipeline,
                                  MutableIndex, build_index)

    out = {}
    m = MutableIndex(build_index(raw[:2000], device=dev), workdir=workdir,
                     device=dev)
    tops.reset_launch_counts()
    pipe = IngestPipeline(m, chunk_series=500)
    pipe.append(raw[2000:4000])
    m.maybe_compact(CompactionPolicy(max_deltas=4))  # minor: the 4 deltas
    m.append(raw[4000:4500])
    out["appends"] = m.exact_knn_batch(queries, k=8, round_size=256)
    out["counts"] = tops.launch_counts()
    m.append(raw[4500:5000])
    m.compact("minor")
    m.compact("major")
    out["major"] = m.exact_knn_batch(queries, k=8, round_size=256)
    del m
    r = MutableIndex.recover(workdir, device=dev)
    out["recover"] = r.exact_knn_batch(queries, k=8, round_size=256)
    r.demote()
    out["cold"] = r.exact_knn_batch(queries, k=8, round_size=256)
    return out


@pytest.mark.cuda
def test_cuda_live_store_matches_cpu(cuda_device, tmp_path):
    raw = random_walk(5000, 128, seed=171)
    queries = random_walk(8, 128, seed=172)
    card = _live_answers(cuda_device, str(tmp_path / "card"), raw, queries)
    cpu = _live_answers(torch.device("cpu"), str(tmp_path / "cpu"), raw,
                        queries)
    for stage in ("appends", "major", "recover", "cold"):
        (d, p), (d0, p0) = card[stage], cpu[stage]
        assert torch.equal(p.cpu(), p0), stage
        torch.testing.assert_close(d.cpu(), d0, rtol=1e-5, atol=1e-5)
    # On the card the folded, recovered and demoted stores answer bit for
    # bit alike: the same rows meet the same kernels, from memory, from
    # files or from the cold tier.
    for stage in ("recover", "cold"):
        assert torch.equal(card[stage][0], card["major"][0]), stage
        assert torch.equal(card[stage][1], card["major"][1]), stage
    counts = card["counts"]
    assert counts["paa_isax"] == 5  # one per appended chunk
    # the fused packed path distances its rows in the engine's round kernel
    assert counts["lower_bound_sq_multi"] == 1 and counts["engine_round"] > 0
    assert cpu["counts"]["paa_isax"] == 0  # the CPU runs the plain versions


@pytest.mark.cuda
def test_cuda_cold_gather_stages_rows_bitwise(cuda_device, tmp_path):
    from repro_torch.core import BlockCache, build_index, coldtier
    from repro_torch.core.build_pipeline import keys_to_u64, refine_key
    from repro_torch.core.search import exact_knn_batch

    raw = random_walk(7000, 128, seed=181)
    queries = random_walk(8, 128, seed=182)
    index = build_index(raw, device=cuda_device)
    workdir = str(tmp_path)
    pos = index.pos.cpu().numpy()
    ref = coldtier.spill_cold_component(
        workdir, "e0", keys_to_u64(refine_key(index.sax, 4, 256)),
        index.sax.cpu().numpy(), pos, index.raw.cpu().numpy()[pos], base=0,
        series_length=128)
    shard = coldtier.load_cold_shard(
        workdir, ref, cache=BlockCache(block_rows=16), segments=16,
        cardinality=256, device=cuda_device)
    qs = tx.znorm(torch.from_numpy(queries).to(cuda_device))
    view = coldtier._cold_view(shard, leaf_cap=256)
    rng = np.random.default_rng(183)
    per_query = torch.from_numpy(
        rng.integers(-1, 7000, size=(8, 300)).astype(np.int32)).to(cuda_device)
    keep = torch.from_numpy(rng.random((8, 300)) < 0.3).to(cuda_device)
    for positions in (per_query, per_query[0]):  # (Q, R) and shared (R,)
        want = tops.euclid_sq_gather(qs, index.raw, positions)
        for mask in (torch.ones_like(keep), keep):
            got = view.distances(qs, positions, "auto", mask)
            assert torch.equal(got[mask], want[mask])
    tops.reset_launch_counts()
    got = coldtier.cold_exact_knn_batch(shard, queries, k=8, round_size=256,
                                        stats=True)
    assert tops.launch_counts()["euclid_sq"] > 0
    assert tops.launch_counts()["engine_round"] == 0  # host rows: plain
    want = exact_knn_batch(index, queries, k=8, round_size=256, stats=True)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    assert got[4] == want[4]


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["index", "packed"])
def test_cuda_one_round_launch_a_round_tried(cuda_device, store):
    """On the card ``launch_counts()["engine_round"]`` counts one launch for
    every main-loop round the engine tries over the index and packed views,
    the one whose exit test ends the loop included; the plain version
    (``impl="ref"``) launches and counts none."""
    from repro_torch.core import build_index
    from repro_torch.core.search import (_packed_view, exact_knn_batch,
                                         exact_knn_batch_packed,
                                         pack_components, select_len)

    raw = random_walk(6144, 128, seed=105)
    queries = random_walk(8, 128, seed=106)
    index = build_index(raw, device=cuda_device)
    rs = 256
    if store == "index":
        n_rows = index.num_series

        def run(impl):
            return exact_knn_batch(index, queries, k=2, round_size=rs,
                                   stats=True, impl=impl)
    else:
        packed = pack_components([(index, 0)])
        n_rows = _packed_view(packed).n_rows

        def run(impl):
            return exact_knn_batch_packed(packed, queries, k=2,
                                          round_size=rs, stats=True,
                                          impl=impl)
    main = -(-select_len(n_rows, rs) // rs)
    tops.reset_launch_counts()
    got = run("auto")
    rounds = got[4]
    assert tops.launch_counts()["engine_round"] == (
        min(rounds, main) + (rounds < main))
    tops.reset_launch_counts()
    run("ref")
    assert tops.launch_counts()["engine_round"] == 0


def _routed_answers(router, queries, clients=3):
    """Every query submitted from ``clients`` threads at once; the stacked
    ((Q, k) dists, (Q, k) positions) as numpy."""
    import threading

    futs = [None] * len(queries)

    def client(c):
        for i in range(c, len(queries), clients):
            futs[i] = router.submit(queries[i])

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    res = [f.result(timeout=60) for f in futs]
    return np.stack([d for d, _ in res]), np.stack([p for _, p in res])


@pytest.mark.cuda
def test_cuda_router_matches_cpu_router(cuda_device):
    """Two shards of two replicas over card engines, their daemons and
    three client threads: the same positions as the same router on the
    CPU, and bit for bit the card's own single-index answers (the same
    rows meet the same kernels, whichever replica or cohort they ride)."""
    from repro_torch.core import build_index
    from repro_torch.core.search import exact_knn_batch
    from repro_torch.serving import ShardedSearchRouter

    raw = random_walk(6000, 128, seed=191)
    queries = random_walk(12, 128, seed=192)
    answers = {}
    for dev in (cuda_device, torch.device("cpu")):
        index = build_index(raw, device=dev)
        r = ShardedSearchRouter(index, 2, k=8, replicas=2, max_batch=4,
                                max_wait_ms=2.0, round_size=256)
        r.start()
        tops.reset_launch_counts()
        try:
            answers[dev.type] = _routed_answers(r, queries)
        finally:
            r.stop()
        answers[dev.type + "_counts"] = tops.launch_counts()
        answers[dev.type + "_stats"] = r.stats()
        answers[dev.type + "_direct"] = exact_knn_batch(
            index, queries, k=8, round_size=256)
    (d, p), (d0, p0) = answers["cuda"], answers["cpu"]
    np.testing.assert_array_equal(p, p0)
    np.testing.assert_allclose(d, d0, rtol=1e-5, atol=1e-5)
    dd, dp = answers["cuda_direct"]
    np.testing.assert_array_equal(d, dd.cpu().numpy())
    np.testing.assert_array_equal(p, dp.cpu().numpy())
    for name in ("lower_bound_sq_batch", "euclid_sq"):
        assert answers["cuda_counts"][name] > 0, answers["cuda_counts"]
        assert answers["cpu_counts"][name] == 0
    s = answers["cuda_stats"]
    assert s["answered"] == 2 * len(queries) and s["merges"] == len(queries)


@pytest.mark.cuda
def test_cuda_ingesting_router_card_batches_match_one_shot_build(cuda_device):
    """Card-tensor appends through the live-ingest router answer as one
    ``build_index`` over the same series, bit for bit, before and after a
    full fold; every append runs ``paa_isax`` on the card."""
    from repro_torch.core import build_index
    from repro_torch.core.search import exact_knn_batch
    from repro_torch.serving import IngestingRouter

    raw = torch.from_numpy(random_walk(7000, 128, seed=201)).to(cuda_device)
    queries = random_walk(8, 128, seed=202)
    want_d, want_p = exact_knn_batch(build_index(raw, device=cuda_device),
                                     queries, k=8, round_size=256)
    svc = IngestingRouter(build_index(raw[:3000], device=cuda_device), 2,
                          k=8, replicas=2, max_batch=8, round_size=256,
                          compaction_policy=None)
    svc.start()
    try:
        tops.reset_launch_counts()
        for s in range(3000, 7000, 1000):
            assert svc.append(raw[s:s + 1000]) == 1000  # stays on the card
        assert tops.launch_counts()["paa_isax"] == 4
        for step in ("appended", "folded"):
            d, p = _routed_answers(svc, queries)
            np.testing.assert_array_equal(p, want_p.cpu().numpy())
            np.testing.assert_array_equal(d, want_d.cpu().numpy())
            if step == "appended":
                assert svc.compact_now("full") is not None
    finally:
        svc.stop()
    assert svc.num_series == 7000 and svc.mutable.num_deltas == 0


def _mesh_answers(dindex, queries, world, backend, store):
    from repro_torch.core import distributed as tdist

    kw = dict(round_size=256, leaf_cap=4)
    plan = [("k1", "batch", dict(kw, k=1)), ("k8", "batch", dict(kw, k=8)),
            ("topk", "search", dict(kw, select="topk", queries=4)),
            ("build", "build", {})]
    rows = dindex.raw_sorted[:2048]
    return tdist.spawn_mesh(
        tdist.run_plan, world, backend=backend,
        init_method=f"file://{store}", timeout=30, join_timeout=120,
        device=dindex.device, args=(dindex, queries, plan, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("world,backend", [(2, "gloo"), (1, "nccl")])
def test_cuda_mesh_matches_cpu_mesh(cuda_device, tmp_path, world, backend):
    """The mesh on the card (gloo ranks share it; one nccl rank) answers
    as the same mesh on the CPU: positions, reads and rounds equal."""
    import dataclasses

    from repro_torch.core import build_index
    from repro_torch.core import distributed as tdist

    raw = random_walk(6001, 128, seed=151)  # world 2 pads one filler row
    rng = np.random.default_rng(152)
    base = tx.znorm(_t(raw[rng.integers(0, 6001, 8)])).numpy()
    queries = (base + 1.5 * rng.standard_normal(base.shape)).astype(
        np.float32)  # loose bounds: the batch forms run their fallback
    on_cpu = tdist.dist_index_from(build_index(raw, device="cpu"), world)
    on_card = dataclasses.replace(
        on_cpu, sax=on_cpu.sax.to(cuda_device),
        raw_sorted=on_cpu.raw_sorted.to(cuda_device),
        pos=on_cpu.pos.to(cuda_device))
    card = _mesh_answers(on_card, torch.from_numpy(queries).to(cuda_device),
                         world, backend, tmp_path / "card")
    cpu = _mesh_answers(on_cpu, torch.from_numpy(queries), world, "gloo",
                        tmp_path / "cpu")
    for name in ("k1", "k8", "topk"):
        a, b = card[0][name], cpu[0][name]
        for f in ("position", "raw_reads", "bsf_updates", "rounds"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{name} {f}")
        np.testing.assert_allclose(a["dist_sq"], b["dist_sq"], rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a["build"]["sax"], b["build"]["sax"])
        np.testing.assert_array_equal(a["build"]["keys"], b["build"]["keys"])
    assert card[0]["k1"]["rounds"] > 4  # 1024 selected rows: 4 main rounds
    launched = {name: sum(r["launches"][name] for r in card)
                for name in card[0]["launches"]}
    for name in ("paa_isax", "lower_bound_sq_batch", "lower_bound_sq",
                 "euclid_sq"):
        assert launched[name] > 0, launched


# Every admitted launch shape (``repro_torch.core.tuning``) against the
# default shape, bitwise, and the default against the plain version, at
# edge sizes: Q past one 64-query block and not a multiple of 32, N not a
# multiple of any row tile, packed pads, lengths on the scalar-load path.
TUNING_EDGE_SHAPES = {"lb_batch": (70, 3001), "lb_multi": (70, 3001),
                      "lb_single": (1, 5001), "euclid": (70, 333),
                      "paa_isax": (1, 3001)}
EUCLID_LENGTHS = {4: 100, 8: 64, 16: 256, 32: 512}  # 100: scalar loads


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 8, 16, 32])
@pytest.mark.parametrize("kernel", sorted(TUNING_EDGE_SHAPES))
def test_cuda_every_admitted_launch_shape_bitwise(cuda_device, kernel, w):
    from repro_torch.core import tuning

    q, n = TUNING_EDGE_SHAPES[kernel]
    length = EUCLID_LENGTHS[w] if kernel == "euclid" else 256

    def runner(impl):
        return tuning.kernel_runner(kernel, q=q, n=n, impl=impl,
                                    length=length, segments=w, seed=w,
                                    raw_rows=4096, device=cuda_device)

    run = runner("auto")

    def outputs(params=None):
        out = run(params)
        torch.cuda.synchronize()
        return out if isinstance(out, tuple) else (out,)

    base = outputs()
    plain = runner("ref")()
    plain = plain if isinstance(plain, tuple) else (plain,)
    if kernel == "euclid":
        torch.testing.assert_close(base[0], plain[0], rtol=1e-5, atol=1e-5)
    else:
        assert all(torch.equal(a, b) for a, b in zip(base, plain))
    for point in tuning.lattice_points(kernel):
        got = outputs(point)
        if kernel == "lb_multi":  # other block_n: other pads; real rows
            assert torch.isinf(got[0][:, n:]).all()
            got, ref = (got[0][:, :n],), (base[0][:, :n],)
        else:
            ref = base
        assert all(torch.equal(a, b) for a, b in zip(ref, got)), point


@pytest.mark.cuda
def test_cuda_unadmitted_launch_shape_raises(cuda_device):
    sax = torch.zeros((300, 16), dtype=torch.uint8, device=cuda_device)
    qp = torch.zeros((4, 16), device=cuda_device)
    bpp = tx.padded_breakpoints(256, cuda_device)
    with pytest.raises(ValueError, match="not an admitted"):
        tops.lower_bound_sq_batch(qp, sax, bpp, 256, threads=64)
    with pytest.raises(ValueError, match="not an admitted"):
        tops.euclid_sq_gather(torch.zeros((2, 64), device=cuda_device),
                              torch.zeros((10, 64), device=cuda_device),
                              torch.zeros(5, dtype=torch.int32,
                                          device=cuda_device),
                              rows_per_warp=16)


@pytest.mark.cuda
def test_cuda_classifier_matches_cpu(cuda_device):
    from repro_torch.core import build_index
    from repro_torch.core.classifier import KnnClassifier

    raw = random_walk(4000, 128, seed=161)
    labels = (raw[:, -1] > raw[:, 0]).astype(np.int64)
    queries = random_walk(6, 128, seed=162)
    cpu = KnnClassifier(build_index(raw, device="cpu"), labels, k=5)
    card = KnnClassifier(build_index(raw, device=cuda_device),
                         torch.from_numpy(labels).to(cuda_device), k=5)
    for q in queries:
        assert card.predict(q) == card.predict_brute(q) == cpu.predict(q)
        np.testing.assert_array_equal(card.kneighbors(q)[1].cpu().numpy(),
                                      cpu.kneighbors(q)[1].numpy())


# ---------------------------------------------------------------------------
# The LM serving path: the same generator-made model on the card and on the
# CPU, in float32 with TF32 off, within 1e-4 (rtol and atol; MoE's
# scatter-add order on the card is not fixed); tokens equal.
# ---------------------------------------------------------------------------

@pytest.fixture
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = old


def _lm_pair(arch, dev, **over):
    import copy
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import Model

    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", **over)
    cpu = Model(cfg, device="cpu",
                generator=torch.Generator().manual_seed(0))
    return cfg, cpu, copy.deepcopy(cpu).to(dev)


def _lm_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _lm_close(got[k], want[k])
        return
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-34b", "jamba-v0.1-52b"])
def test_cuda_lm_matches_cpu(cuda_device, no_tf32, arch):
    from repro_torch.serving.kv_cache import pad_cache_to
    from repro_torch.serving.serve_step import greedy_generate

    cfg, cpu, card = _lm_pair(arch, cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(171).integers(
        0, cfg.vocab_size, (2, 16)))
    for want, got in zip(cpu.apply({"tokens": tokens}),
                         card.apply({"tokens": tokens.to(cuda_device)})):
        if want is not None:
            _lm_close(got, want)
    res = []
    for model in (cpu, card):
        t = tokens.to(model.device)
        logits, cache = model.prefill({"tokens": t[:, :15]})
        cache = pad_cache_to(cache, 16)
        last, cache = model.decode_step({"tokens": t[:, 15:]}, cache, 15)
        res.append((logits, last, cache))
    for want, got in zip(*res):
        _lm_close(got, want)
    assert torch.equal(
        greedy_generate(card, tokens[:, :5].to(cuda_device), 6).cpu(),
        greedy_generate(cpu, tokens[:, :5], 6))


@pytest.mark.cuda
def test_cuda_slot_batcher_matches_cpu(cuda_device, no_tf32):
    from repro_torch.serving.batcher import Request, SlotBatcher

    cfg, cpu, card = _lm_pair("granite-34b", cuda_device)
    prompts = [(np.arange(n, dtype=np.int32) * 3 + i) % cfg.vocab_size
               for i, n in enumerate((4, 7, 5))]
    done = []
    for model in (cpu, card):
        b = SlotBatcher(model, batch_size=2, max_len=32)
        for i, p in enumerate(prompts):
            b.submit(Request(rid=i, prompt=p, max_new=5))
        done.append(b.run(40))
    assert sorted(done[0]) == sorted(done[1]) == [0, 1, 2]
    for rid in done[0]:
        np.testing.assert_array_equal(done[1][rid], done[0][rid])


@pytest.mark.cuda
def test_cuda_retrieval_serve_matches_cpu(cuda_device, no_tf32):
    from repro_torch.examples import retrieval_serve

    cfg, cpu, card = _lm_pair("granite-34b", cuda_device, d_model=64,
                              vocab_size=512)
    np.testing.assert_array_equal(retrieval_serve.run(card),
                                  retrieval_serve.run(cpu))


# ---------------------------------------------------------------------------
# LM training: the same generator-made model trained on the card and on the
# CPU in float32 with TF32 off. Metrics within 1e-4 relative; moments within
# 1e-3 of their leaf's largest magnitude; masters within lr / 4 (an Adam
# step moves a weight by up to lr whatever its gradient's size, so one
# whose gradient is within float noise of 0 may move either way).
# ---------------------------------------------------------------------------

def _train_states(arch, dev, **over):
    from repro_torch.training import train_step as ts

    cfg, cpu, card = _lm_pair(arch, dev, **over)
    return cfg, ts.init_train_state(cpu), ts.init_train_state(card)


def _bigram(step, cfg, dev, b=4, s=16):
    from repro_torch.training import data as data_mod

    return {k: torch.from_numpy(v).to(dev) for k, v in
            data_mod.bigram_batch(step, b, s, cfg.vocab_size).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-34b", "olmoe-1b-7b"])
def test_cuda_train_steps_match_cpu(cuda_device, no_tf32, arch):
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts

    cfg, cpu, card = _train_states(arch, cuda_device)
    ocfg = opt_mod.OptimizerConfig(warmup_steps=1, total_steps=10)
    tcfg = ts.TrainConfig(optimizer=ocfg, microbatches=2)
    for step in range(2):
        ms = []
        for st in (cpu, card):
            _, m = ts.make_train_step(st.model, tcfg)(
                st, _bigram(step, cfg, st.device))
            ms.append(m)
        for k in ms[0]:
            np.testing.assert_allclose(float(ms[1][k]), float(ms[0][k]),
                                       rtol=1e-4, err_msg=k)
    for name, a, b in zip(cpu.names, cpu.master, card.master):
        torch.testing.assert_close(b.cpu(), a, rtol=0,
                                   atol=ocfg.learning_rate / 4, msg=name)
    for moments in ("mu", "nu"):
        for name, a, b in zip(cpu.names, getattr(cpu.opt, moments),
                              getattr(card.opt, moments)):
            tol = 1e-3 * float(a.abs().max()) + 1e-30
            torch.testing.assert_close(b.cpu(), a, rtol=0, atol=tol,
                                       msg=name)


@pytest.mark.cuda
def test_cuda_checkpoint_restores_on_cpu_bitwise(cuda_device, tmp_path):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_step as ts

    cfg = configs.get_smoke_config("granite-34b")  # bf16 with f32 masters
    card = ts.init_train_state(Model(
        cfg, device=cuda_device,
        generator=torch.Generator(cuda_device).manual_seed(0)))
    card, _ = ts.make_train_step(card.model, ts.TrainConfig())(
        card, _bigram(0, cfg, cuda_device))
    ckpt.save(str(tmp_path), 1, card)
    cpu = ts.init_train_state(Model(dataclasses.replace(cfg), device="cpu",
                                    generator=torch.Generator()))
    ckpt.restore(str(tmp_path), 1, cpu)
    assert int(cpu.opt.step) == int(card.opt.step) == 1
    for got, want in ((cpu.master, card.master), (cpu.opt.mu, card.opt.mu),
                      (cpu.opt.nu, card.opt.nu), (cpu.params, card.params)):
        for a, b in zip(got, want):  # the bf16 copies refreshed too
            assert a.dtype == b.dtype and torch.equal(a, b.detach().cpu())


@pytest.mark.cuda
def test_cuda_prefetching_loader_yields_card_tensors(cuda_device):
    from repro_torch.training import data as data_mod

    loader = data_mod.PrefetchingLoader(data_mod.bigram_batch, 2, 16, 100,
                                        start_step=4, device=cuda_device)
    try:
        for want in (4, 5, 6):
            step, batch = next(loader)
            assert step == want
            ref = data_mod.bigram_batch(step, 2, 16, 100)
            for k, v in batch.items():
                assert v.device == cuda_device
                np.testing.assert_array_equal(v.cpu().numpy(), ref[k])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [
    ("granite-34b", dict(attn_dense_threshold=8, attn_flash_q_block=8,
                         attn_flash_kv_block=8)),
    ("rwkv6-1.6b", {})], ids=["granite-flash", "rwkv6"])
def test_cuda_remat_on_equals_off_bitwise(cuda_device, no_tf32, arch, over):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.training import train_step as ts

    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", **over)
    batch = _bigram(1, cfg, cuda_device, b=2, s=32)
    out = []
    for remat in (True, False):
        model = Model(cfg, device=cuda_device, remat=remat,
                      generator=torch.Generator(cuda_device).manual_seed(0))
        st = ts.init_train_state(model)
        loss, _ = ts.make_loss_fn(model, ts.TrainConfig())(batch)
        out.append((loss, torch.autograd.grad(loss, st.params)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.cuda
def test_cuda_sharded_step_on_one_nccl_rank_is_bitwise(cuda_device,
                                                       tmp_path):
    """The train step on a state distributed over a one-rank (1, 1) mesh
    (NCCL) equals the plain step bit for bit: every collective is the
    identity there. bf16 with float32 masters, remat, 2 microbatches."""
    from repro_torch import configs
    from repro_torch.core import distributed as tdist
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import sharding
    from repro_torch.training import train_step as ts

    cfg = configs.get_smoke_config("granite-34b")  # bf16
    tcfg = ts.TrainConfig(optimizer=opt_mod.OptimizerConfig(
        warmup_steps=0, total_steps=10), microbatches=2)
    batches = [data_mod.bigram_batch(i, 4, 64, cfg.vocab_size)
               for i in range(2)]
    plan = [("a", "plain_vs_sharded", dict(
        cfg=cfg, tcfg=tcfg, seed=0, batches=batches,
        axes=("data", "model"), remat=True))]
    got = tdist.spawn_mesh(
        sharding.run_plan, 1, backend="nccl",
        init_method=f"file://{tmp_path}/store", timeout=60,
        join_timeout=240, device=cuda_device, args=(plan,))[0]["a"]
    assert got["loss_equal"] and got["norm_equal"], got
    assert got["master_equal"], got["master_max_diff"]


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [True, False])
def test_cuda_moe_forward_backward_replays_bitwise(cuda_device, no_tf32,
                                                   monkeypatch,
                                                   deterministic):
    """olmoe smoke's MoE layer, forward and backward, twice on the card:
    the same output and gradients bit for bit, with and without
    ``torch.use_deterministic_algorithms`` (the combine sums a token's k
    contributions in a fixed order, never by atomics)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import Model, moe

    cfg = dataclasses.replace(configs.get_smoke_config("olmoe-1b-7b"),
                              dtype="float32")
    layer = Model(cfg, device=cuda_device,
                  generator=torch.Generator(cuda_device).manual_seed(0)
                  ).blocks[0].moe
    layer.requires_grad_(True)
    x0 = torch.randn(4, 64, cfg.d_model, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(1))
    if deterministic:  # cuBLAS needs a fixed workspace to be deterministic
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        runs = []
        for _ in range(2):
            x = x0.clone().requires_grad_(True)
            out, aux = moe.moe_ffn(layer, x, num_experts=cfg.num_experts,
                                   top_k=cfg.num_experts_per_tok,
                                   capacity_factor=cfg.capacity_factor)
            loss = (out * out).sum() + aux
            grads = torch.autograd.grad(loss, [x, *layer.parameters()])
            runs.append([out.detach(), *grads])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(old)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# --- The candidate selection (csrc/select.cu) ---------------------------------


def _selection_cases():
    from test_torch_select import selection_cases  # a file without JAX

    return selection_cases()


def _smallest(lb, k):
    """The k smallest of each row, ascending, by the kernels: ``select``,
    then ``order_range`` over the whole list."""
    cols, bounds, _ = tops.select(lb, k)
    return tops.order_range(bounds, cols, 0, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_selection_cases()))
def test_cuda_smallest_bitwise(cuda_device, name):
    lb, k = _selection_cases()[name]
    lb = torch.from_numpy(lb).to(cuda_device)
    tops.reset_launch_counts()
    cols, bounds = _smallest(lb, k)
    torch.cuda.synchronize()
    counts = tops.launch_counts()
    assert counts["select"] == counts["order_range"] == 1
    want_cols, want_bounds = tref.smallest(lb, k)
    assert torch.equal(cols, want_cols)
    assert torch.equal(bounds.view(torch.int32), want_bounds.view(torch.int32))


@pytest.mark.cuda
def test_cuda_smallest_on_random_walk_bounds(cuda_device):
    """The engine's own input: (64, 2^20) bounds of z-normed random walks
    against 64 noisy members, k = 2^16."""
    from repro_torch.core import build_index

    gen = torch.Generator(device=cuda_device).manual_seed(26)
    raw = torch.randn((1 << 20, 256), generator=gen,
                      device=cuda_device).cumsum_(dim=1)
    index = build_index(raw, device=cuda_device)
    noise = torch.randn((64, 256), generator=gen, device=cuda_device)
    qs = tx.znorm(raw[:64] + 0.25 * raw[:64].std(dim=1, keepdim=True) * noise)
    del raw
    bpp = tx.padded_breakpoints(index.cardinality, cuda_device)
    lb = tops.lower_bound_sq_batch(tx.paa(qs, index.segments), index.sax,
                                   bpp, index.series_length)
    cols, bounds = _smallest(lb, 1 << 16)
    want_cols, want_bounds = tref.smallest(lb, 1 << 16)
    torch.cuda.synchronize()
    assert torch.equal(cols, want_cols)
    assert torch.equal(bounds, want_bounds)


@pytest.mark.cuda
def test_cuda_one_smallest_launch_set_per_batch_call(cuda_device):
    """The engine selects once a call (``select``) and orders its first
    prefix and each extension (``order_range``)."""
    from repro_torch.core import build_index
    from repro_torch.core.search import exact_knn_batch

    index = build_index(random_walk(6000, 128, seed=261), device=cuda_device)
    queries = random_walk(8, 128, seed=262)
    for calls in (1, 2):
        tops.reset_launch_counts()
        for _ in range(calls):
            exact_knn_batch(index, queries, k=4, round_size=64)
        torch.cuda.synchronize()
        counts = tops.launch_counts()
        assert counts["select"] == calls
        assert counts["order_range"] >= calls


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_selection_cases()))
def test_cuda_select_and_order_range_bitwise(cuda_device, name):
    """Both phases of the engine's selection against their plain versions:
    ``select`` whole, and ``order_range`` over three pieces of its list,
    each after the first given the piece before's last entry."""
    lb, k = _selection_cases()[name]
    lb = torch.from_numpy(lb).to(cuda_device)
    tops.reset_launch_counts()
    got = tops.select(lb, k)
    torch.cuda.synchronize()
    assert tops.launch_counts()["select"] == 1
    want = tops.select(lb, k, impl="ref")
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    cols, bounds, _ = want
    cuts = sorted({0, k // 3, (2 * k) // 3, k})
    prev = ()
    for lo, hi in zip(cuts, cuts[1:]):
        part = tops.order_range(bounds, cols, lo, hi, *prev)
        plain = tops.order_range(bounds, cols, lo, hi, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(part[0], plain[0])
        assert torch.equal(part[1].view(torch.int32),
                           plain[1].view(torch.int32))
        prev = (part[1][:, -1], part[0][:, -1])
    assert tops.launch_counts()["order_range"] == len(cuts) - 1


def _engine_rounds(dev, q, rs, width, n, k, tiered, seed):
    """Three rounds of the batch engine's loop on the card, as the kernel
    and as its plain version (``ref.engine_round`` with the gather kernel's
    distances, which launches no round) run them, chained: each round's
    (q, width) columns and bounds are views of a wider list; a position
    table over 2^14 z-normed rows has ``NO_POS`` pads (+inf bounds); query 2's first round holds two rows
    equal to it (a tie at distance 0, the lower column wins); a third of
    the candidates beat the k-th best, one result list is unfilled (+inf),
    one is done (0). Yields each round's (name, kernel's tensor, plain
    version's tensor) pairs."""
    from repro_torch.kernels import euclidean

    gen = torch.Generator(device=dev).manual_seed(seed)
    raw = tx.znorm(_t(random_walk(1 << 14, n, seed=seed)).to(dev))
    pos_table = torch.cat([
        torch.randperm(1 << 14, generator=gen, device=dev),
        torch.full((512,), -1, device=dev)]).to(torch.int32)
    qs = raw[torch.randint(0, 1 << 14, (q,), generator=gen, device=dev)]
    qs = tx.znorm(qs + 0.5 * torch.randn(qs.shape, generator=gen,
                                         device=dev))
    wide = 3 * rs + 11
    cols = torch.randint(0, pos_table.shape[0], (q, wide), generator=gen,
                         device=dev, dtype=torch.int32)
    # Query 2's round-0 columns 1 and 4: two rows equal to the query.
    a, b = (int(pos_table[i]) for i in range(2))
    cols[2, 7 + 1], cols[2, 7 + 4] = 0, 1
    raw[a] = raw[b] = qs[2]
    d = tops.euclid_sq_gather(qs, raw, pos_table[cols.long()])
    kth = d.quantile(0.05, dim=1) + 1.0
    top_d = torch.sort(torch.rand((q, k), generator=gen, device=dev), 1
                       ).values * kth[:, None]
    top_d[:, -1] = kth
    top_d[0] = float("inf")
    top_d[1] = 0.0
    top_p = torch.randint(0, 1 << 14, (q, k), generator=gen, device=dev,
                          dtype=torch.int32)
    top_p[0] = -1
    tiers = (None, None, None)
    if tiered:
        tiers = (1.0 + torch.rand(q, generator=gen, device=dev),
                 torch.randint(0, 3, (q,), generator=gen, device=dev,
                               dtype=torch.int32),
                 torch.full((q,), float("inf"), device=dev))
    sides = {}
    for side in ("kernel", "plain"):
        sides[side] = dict(
            top=[top_d.clone(), top_p.clone(),
                 torch.arange(q, dtype=torch.int32, device=dev),
                 torch.zeros(q, dtype=torch.int32, device=dev)],
            tiers=tuple(None if t is None else t.clone() for t in tiers),
            state=torch.zeros(3 * q + 2, dtype=torch.int64, device=dev))
    bounds = torch.empty((q, wide), device=dev)
    for r in range(3):
        # round r's bounds: a third below each k-th best as it stands
        lo = 7 + r * rs
        cur = sides["plain"]["top"][0][:, -1]
        scale = torch.where(cur.isfinite(), cur, kth)[:, None] / 0.3
        bounds[:, lo:lo + width] = torch.sort(torch.rand(
            (q, width), generator=gen, device=dev), 1).values * scale
        bounds[pos_table[cols.long()] < 0] = float("inf")
        view = (cols[:, lo:lo + width], bounds[:, lo:lo + width])
        outs = {}
        for side, st in sides.items():
            out = ((torch.full((q, rs), -7.0, device=dev),
                    torch.full((q, rs), 9, dtype=torch.int32, device=dev))
                   if k > 1 else (None, None))
            hooks = (lambda c: pos_table[c.long()],
                     lambda q_, p, m: tops.euclid_sq_gather(q_, raw, p))
            args = (*view, r, rs, *hooks, qs, *st["top"], st["state"],
                    *st["tiers"], *out)
            before = euclidean.round_launches.value
            if side == "kernel":
                tops.engine_round(*view, r, rs, (pos_table, raw), qs,
                                  *st["top"], st["state"], tiers=st["tiers"],
                                  out=out)
                torch.cuda.synchronize()
                assert euclidean.round_launches.value == before + 1
            else:
                tref.engine_round(*args)
                assert euclidean.round_launches.value == before
            assert not st["state"][:-1].any()  # the words back at 0
            outs[side] = out
        a, b = sides["kernel"], sides["plain"]
        names = ("top_d", "top_p", "reads", "updates")
        pairs = list(zip(names, a["top"], b["top"]))
        pairs += [("skip_lb", a["tiers"][2], b["tiers"][2]),
                  ("flag", a["state"][-1:], b["state"][-1:]),
                  ("out_d", *(o[0] for o in outs.values())),
                  ("out_p", *(o[1] for o in outs.values()))]
        yield r, [(nm, x, y) for nm, x, y in pairs if x is not None]
        if k > 1:  # the engine's merge, the same on both sides
            from repro_torch.core.search import merge_round
            for side, st in sides.items():
                st["top"][:2] = merge_round(*st["top"][:2], outs[side][1],
                                            outs[side][0])


@pytest.mark.cuda
@pytest.mark.parametrize("q,rs,width,n", [(64, 4096, 4096, 256),
                                          (7, 300, 250, 100)])
@pytest.mark.parametrize("k,tiered", [(1, False), (4, False), (1, True),
                                      (4, True)])
def test_cuda_engine_round_bitwise(cuda_device, q, rs, width, n, k, tiered):
    """The round kernel against its plain version, bit for bit, at the main
    path's shape (Q = 64, rs = 4096, n = 256) and at a ragged one (a round
    shorter than rs, rs not a multiple of the block, n not of 4), round
    after round: distances, positions, reads, updates, skip_lb and the
    flag; a round whose exit test fails writes the flag alone."""
    ran = 0
    for r, pairs in _engine_rounds(cuda_device, q, rs, width, n, k, tiered,
                                   seed=300 + q + k):
        for name, got, want in pairs:
            bits = [t.view(torch.int32) if t.is_floating_point() else t
                    for t in (got, want)]
            assert torch.equal(*bits), (r, name)
        ran += 1
    assert ran == 3
    # every k-th best at 0: the test fails, and only the flag changes
    z = torch.zeros((2, k), device=cuda_device)
    p = torch.full((2, k), 5, dtype=torch.int32, device=cuda_device)
    cnt = torch.ones(2, dtype=torch.int32, device=cuda_device)
    state = torch.full((8,), 0, dtype=torch.int64, device=cuda_device)
    state[-1] = 1
    raw = torch.ones((4, n), device=cuda_device)
    bnd = torch.zeros((2, 8), device=cuda_device)
    col = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
    out = ((torch.full((2, 8), -7.0, device=cuda_device),
            torch.full((2, 8), 9, dtype=torch.int32, device=cuda_device))
           if k > 1 else (None, None))
    tops.engine_round(col, bnd, 0, 8, (torch.zeros(4, dtype=torch.int32,
                                                   device=cuda_device), raw),
                      raw[:2], z, p, cnt, cnt.clone(), state, out=out)
    torch.cuda.synchronize()
    assert state.tolist() == [0] * 8 and (z == 0).all() and (p == 5).all()
    assert cnt.tolist() == [1, 1]
    assert out[0] is None or ((out[0] == -7).all() and (out[1] == 9).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["levels", "exponential"])
def test_cuda_candidate_list_at_the_main_path_shape(cuda_device, kind):
    """The engine's candidate list at (64, 2^24) bounds, 2^20 selected,
    rounds of 4096: round by round it reads ``ref.smallest``'s list bit for
    bit, over its first prefix (2^15 entries, a 32nd of the list) and its
    first two extensions (to 2^17 and 2^19 entries). ``levels``: 4096
    values, so every cut falls among ties."""
    from repro_torch.core.search import CandidateList

    gen = torch.Generator(device=cuda_device).manual_seed(29)
    shape = (64, 1 << 24)
    if kind == "levels":
        lb = torch.randint(0, 4096, shape, generator=gen, device=cuda_device,
                           dtype=torch.int32).float().mul_(0.125)
    else:
        lb = torch.empty(shape, device=cuda_device).exponential_(
            generator=gen)
    sel, rs = 1 << 20, 4096
    want_cols, want_bounds = tref.smallest(lb, sel)
    cands = CandidateList(lb, sel, rs, "auto")
    del lb
    assert torch.equal(cands.last, want_bounds[:, -1])
    seen = [cands.ordered]
    for r in range(33):
        head = cands.head(r)
        cols, bounds = cands.round(r)
        assert torch.equal(head, want_bounds[:, r * rs])
        assert torch.equal(cols, want_cols[:, r * rs:(r + 1) * rs])
        assert torch.equal(bounds, want_bounds[:, r * rs:(r + 1) * rs])
        if cands.ordered != seen[-1]:
            seen.append(cands.ordered)
    assert seen == [1 << 15, 1 << 17, 1 << 19]


# --- The kernel operators (torch.ops.repro_torch) and the dry-run ---------


def _op_cases(dev):
    """Each operator's arguments on the card, and the direct wrapper call
    they must equal bit for bit."""
    from repro_torch.kernels import euclidean as keu
    from repro_torch.kernels import lower_bound as klb
    from repro_torch.kernels import paa_isax as kpi
    from repro_torch.kernels import select as ksel

    z = tx.znorm(_t(random_walk(3000, 256, seed=111))).to(dev)
    q = tx.znorm(_t(random_walk(9, 256, seed=112))).to(dev)
    bp = tx.gaussian_breakpoints(256, dev)
    bpp = tx.padded_breakpoints(256, dev)
    sax, _ = tx.convert_to_sax(z, 16, 256, normalize=False)
    qp = tx.paa(q, 16)
    pos = torch.randint(0, 3000, (9, 77), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev, dtype=torch.int32)
    n_pad = 3072
    sax_pad = torch.zeros((n_pad, 16), dtype=torch.uint8, device=dev)
    sax_pad[:3000] = sax
    block_len = torch.full((n_pad // 128,), 128, dtype=torch.int32,
                           device=dev)
    block_len[-1] = 3000 - 128 * (n_pad // 128 - 1)
    return {
        "paa_isax": ((z, bp, 16, False), kpi.paa_isax_cuda, kpi.launches),
        "lower_bound_sq_batch": ((qp, sax, bpp, 256),
                                 klb.lower_bound_sq_batch_cuda, klb.launches),
        "lower_bound_sq": ((qp[0].contiguous(), sax, bpp, 256),
                           klb.lower_bound_sq_cuda, klb.single_launches),
        "lower_bound_sq_multi": ((qp, sax_pad, bpp, 256, block_len, 128),
                                 klb.lower_bound_sq_multi_cuda,
                                 klb.multi_launches),
        "euclid_sq_gather": ((q, z, pos), keu.euclid_sq_gather_cuda,
                             keu.launches),
        "euclid_min": ((q[0].contiguous(), z), keu.euclid_min_cuda,
                       keu.min_launches),
        "select": ((z[:9].contiguous(), 100), ksel.select_cuda,
                   ksel.select_launches),
        "order_range": ((z[:9, :200].abs().contiguous(),
                         torch.arange(200, dtype=torch.int32,
                                      device=dev).expand(9, -1).contiguous(),
                         0, 50), ksel.order_range_cuda,
                        ksel.range_launches),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paa_isax", "lower_bound_sq_batch",
                                  "lower_bound_sq", "lower_bound_sq_multi",
                                  "euclid_sq_gather", "euclid_min",
                                  "select", "order_range"])
def test_cuda_operator_equals_wrapper_and_counts_once(cuda_device, name):
    args, wrapper, counter = _op_cases(cuda_device)[name]
    want = wrapper(*args)
    before = counter.value
    got = getattr(torch.ops.repro_torch, name)(*args)
    torch.cuda.synchronize()
    assert counter.value == before + 1
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_smoke_dryrun_traces_on_fake_cuda(cuda_device):
    """A smoke-config train cell and the paris search cell traced on fake
    ``cuda`` tensors, in a process of their own (the fake process group
    stays there), on a machine with a card: nothing launches."""
    import json
    import os
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import dataclasses, json
        from repro_torch import configs
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.kernels import ops
        from repro_torch.launch import dryrun, specs
        from repro_torch.launch.mesh import make_debug_mesh
        smoke = configs.get_smoke_config("granite-34b")
        over = {f.name: getattr(smoke, f.name)
                for f in dataclasses.fields(smoke)}
        with dryrun.fake_world(8):
            mesh = make_debug_mesh((2, 2))
            train = dryrun.traced(lambda: specs.build_cell(
                "granite-34b", "t", mesh, overrides=over,
                shape=ShapeConfig("t", 64, 8, "train"),
                microbatch_tokens_per_device=128), 4)
            search = dryrun.traced(
                lambda: specs.build_paris_cell("search", mesh), 4)
        print(json.dumps(dict(train=train, search=search,
                              launches=ops.launch_counts()), default=str))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["train"]["status"] == "ok"
    assert rec["train"]["roofline"]["flops"] > 0
    assert rec["train"]["roofline"]["collective_bytes"] > 0
    assert rec["search"]["status"] == "ok"
    assert rec["search"]["roofline"]["unknown_trip_bodies"]
    assert not any(rec["launches"].values())

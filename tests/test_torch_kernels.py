"""Port parity, kernel modules: repro_torch.kernels against repro.kernels.

On the CPU the port's ``ops`` take the plain versions (``kernels/ref.py``);
they are held bit for bit against the JAX package's plain versions
(``impl="ref"``) and its Pallas kernels run in interpret mode
(``impl="pallas"``, tiny shapes). The three lower bounds and ``paa_isax``
are bitwise (pad rows and dead blocks of the packed form included);
``euclid_sq`` and ``euclid_min`` (sums of 256 values) are bitwise against
the reference's plain version where the host's XLA sums like the port
(``reference_sums_like_port``), else equal to rounding, and within 1e-6
relative of the Pallas kernel, whose interpret-mode sum may take another
order; ``euclid_min``'s index is always the reference's.

The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datagen
from repro.core import isax as jx
from repro.kernels import ops as jops
from repro_torch.core import isax as tx
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from test_torch_cuda import _edge_inputs
from test_torch_search import assert_float_parity


def _t(a):
    return torch.from_numpy(np.array(a))


def _znormed(rows, n, seed):
    return np.asarray(jx.znorm(jnp.asarray(datagen.random_walk(rows, n, seed))))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("rows,n,w", [(256, 64, 16), (300, 256, 16),
                                      (256, 128, 8)])
def test_paa_isax_matches_reference(impl, rows, n, w):
    z = _znormed(rows, n, seed=rows + n)
    bp = jx.gaussian_breakpoints(256)
    j_sax, j_paa = jops.paa_isax(jnp.asarray(z), bp, w, impl=impl,
                                 normalize=False)
    t_sax, t_paa = tops.paa_isax(_t(z), tx.gaussian_breakpoints(256), w,
                                 normalize=False)
    np.testing.assert_array_equal(t_paa.numpy(), np.asarray(j_paa))
    np.testing.assert_array_equal(t_sax.numpy(), np.asarray(j_sax))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_paa_isax_normalize_true_close_to_reference(impl):
    # The TPU kernel's own z-norm, (x - mean) * rsqrt(var + 1e-16): rsqrt
    # differs by an ulp between the two libraries, so PAA agrees to 1e-5
    # and a symbol may move only where PAA lies that close to a breakpoint.
    raw = datagen.random_walk(256, 128, seed=3)
    bp = jx.gaussian_breakpoints(256)
    j_sax, j_paa = jops.paa_isax(jnp.asarray(raw), bp, 16, impl=impl)
    t_sax, t_paa = tops.paa_isax(_t(raw), tx.gaussian_breakpoints(256), 16)
    np.testing.assert_allclose(t_paa.numpy(), np.asarray(j_paa), atol=1e-5)
    moved = t_sax.numpy() != np.asarray(j_sax)
    near = np.min(np.abs(np.asarray(j_paa)[..., None] - np.asarray(bp)),
                  axis=-1) < 1e-5
    assert np.all(near[moved])


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("n_q,rows,w", [(8, 1024, 16), (5, 700, 8)])
def test_lower_bound_batch_bitwise(impl, n_q, rows, w):
    z = _znormed(rows, 256, seed=rows)
    q = _znormed(n_q, 256, seed=rows + 1)
    sax = np.asarray(jx.convert_to_sax(jnp.asarray(z), w, normalize=False)[0])
    qp = np.asarray(jx.paa(jnp.asarray(q), w))
    want = np.asarray(jops.lower_bound_sq_batch(
        jnp.asarray(qp), jnp.asarray(sax), jx.padded_breakpoints(256), 256,
        impl=impl))
    got = tops.lower_bound_sq_batch(_t(qp), _t(sax), tx.padded_breakpoints(),
                                    256).numpy()
    if impl == "ref":
        np.testing.assert_array_equal(got, want)
    else:
        # The reference's interpret-mode Pallas kernel itself sits up to
        # 3 ulp from the reference's plain version (XLA fuses its segment
        # loop differently); the port matches the plain version bit for
        # bit (the "ref" case), so it is held to that same 3-ulp gap here.
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 3


def test_lower_bound_single_is_plain_only():
    # On the CPU the single-query op is its plain version; the transposed
    # flag (a TPU lane layout) changes nothing in the port.
    z = _znormed(500, 256, seed=21)
    q = _znormed(1, 256, seed=22)[0]
    sax = np.asarray(jx.convert_to_sax(jnp.asarray(z), normalize=False)[0])
    qp = np.asarray(jx.paa(jnp.asarray(q), 16))
    want = np.asarray(jops.lower_bound_sq(
        jnp.asarray(qp), jnp.asarray(sax), jx.padded_breakpoints(), 256,
        impl="ref"))
    for transposed in (False, True):
        got = tops.lower_bound_sq(_t(qp), _t(sax), tx.padded_breakpoints(),
                                  256, transposed=transposed)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("rows,w", [(1000, 16), (700, 8)])
def test_lower_bound_single_vs_pallas(transposed, rows, w):
    # The interpret-mode TPU kernels (rows and cols layouts), N not a
    # multiple of their block: the reference pads and slices. Like the
    # batch kernel, they sit up to 3 ulp from the reference's plain
    # version (in 29% of the rows here), which the port matches bit for
    # bit (test above); the port is held to that same 3-ulp gap.
    z = _znormed(rows, 256, seed=rows + w)
    q = _znormed(1, 256, seed=rows + w + 1)[0]
    sax = np.asarray(jx.convert_to_sax(jnp.asarray(z), w, normalize=False)[0])
    qp = np.asarray(jx.paa(jnp.asarray(q), w))
    want = np.asarray(jops.lower_bound_sq(
        jnp.asarray(qp), jnp.asarray(sax), jx.padded_breakpoints(), 256,
        impl="pallas", block_n=256, transposed=transposed))
    got = tops.lower_bound_sq(_t(qp), _t(sax), tx.padded_breakpoints(), 256,
                              transposed=transposed).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 3


def _packed_case(n_q, w):
    """A packed buffer of three components (pads between them) + 2 dead blocks."""
    sizes, block = (200, 77, 130), 128
    z = _znormed(sum(sizes), 256, seed=sum(sizes) + w)
    sax = np.asarray(jx.convert_to_sax(jnp.asarray(z), w, normalize=False)[0])
    parts, lens, start = [], [], 0
    for m in sizes:
        pad = (-m) % block
        parts += [sax[start:start + m], np.zeros((pad, w), np.uint8)]
        full = np.full(((m + pad) // block,), block, np.int32)
        full[-1] = block - pad
        lens.append(full)
        start += m
    parts.append(np.full((2 * block, w), 255, np.uint8))  # dead tail blocks
    lens.append(np.zeros((2,), np.int32))
    q = _znormed(n_q, 256, seed=w)
    qp = np.asarray(jx.paa(jnp.asarray(q), w))
    return qp, np.concatenate(parts), np.concatenate(lens), block


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("n_q,w", [(5, 16), (8, 8)])
def test_lower_bound_multi_bitwise_incl_pads_and_dead_blocks(impl, n_q, w):
    qp, sax, block_len, block = _packed_case(n_q, w)
    want = np.asarray(jops.lower_bound_sq_multi(
        jnp.asarray(qp), jnp.asarray(sax), jx.padded_breakpoints(), 256,
        jnp.asarray(block_len), impl=impl, block_n=block))
    got = tops.lower_bound_sq_multi(_t(qp), _t(sax), tx.padded_breakpoints(),
                                    256, _t(block_len), block_n=block).numpy()
    valid = (np.arange(block)[None, :] < block_len[:, None]).reshape(-1)
    assert np.all(np.isinf(got[:, ~valid])) and np.all(np.isfinite(
        got[:, valid]))
    if impl == "ref":
        np.testing.assert_array_equal(got, want)
    else:
        # Real rows: the same 3-ulp gap as the batch kernel (see above);
        # pad rows and dead blocks: +inf in both.
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        ulps = np.abs(got[:, valid].view(np.int32).astype(np.int64)
                      - want[:, valid].view(np.int32).astype(np.int64))
        assert ulps.max() <= 3


def _q_grid(kind):
    bp = tx.padded_breakpoints(256)  # every breakpoint, with -BIG and +BIG
    if kind == "breakpoints":
        return bp
    if kind in ("above", "below"):
        return torch.nextafter(bp, torch.tensor(
            float("inf") if kind == "above" else float("-inf")))
    if kind == "zeros":
        return torch.tensor([0.0, -0.0])
    if kind == "big":
        big = torch.tensor([tx.BIG, -tx.BIG], dtype=torch.float32)
        return torch.cat([big, torch.nextafter(big, torch.zeros(2)),
                          torch.nextafter(big, 2 * big)])
    return _t(np.random.default_rng(7).standard_normal(4096)
              .astype(np.float32) * 3)


@pytest.mark.parametrize("kind", ["breakpoints", "above", "below", "zeros",
                                  "big", "random"])
def test_lower_bound_relu_max_on_bits(kind):
    # The CUDA kernel takes max(q - hi, lo - q, 0) as one integer max with
    # relu on the float bit patterns (__vimax_s32_relu). Over every symbol's
    # region (card 256) it must equal the plain version's float max and give
    # the same bits once squared; the kernel itself runs only on the card.
    bpp = tx.padded_breakpoints(256)
    lo, hi = bpp[:-1][None, :], bpp[1:][None, :]
    q = _q_grid(kind)[:, None]
    a, b = q - hi, lo - q
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    assert not ((a > 0) & (b > 0)).any()  # lo <= hi: one side at most
    on_bits = torch.clamp_min(torch.maximum(
        a.view(torch.int32), b.view(torch.int32)), 0).view(torch.float32)
    plain = torch.clamp_min(torch.maximum(a, b), 0)
    assert torch.equal(on_bits, plain)
    assert not torch.signbit(on_bits).any()
    assert torch.equal((on_bits * on_bits).view(torch.int32),
                       (plain * plain).view(torch.int32))


@pytest.mark.parametrize("card", [2, 16, 64, 128, 256])
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_lower_bound_single_lookup_scheme_bitwise(card, w):
    # lb_single_kernel (csrc/lower_bound.cu) in plain PyTorch. Thread s
    # writes entry s of the padded table to s_bp[s * 32 + (l + s) % 32] at
    # step l. The thread of row r is lane r % 32 (tiles and the grid stride
    # are multiples of 32); it reads lo at s_bp[sym * 32 + lane] and hi 32
    # floats on, takes the gap as an integer max with relu on the float
    # bits, and sums from the first square in the order of j, scale last.
    # Every (symbol, lane) pair and every edge PAA of _edge_inputs must give
    # the plain version's bits; unwritten slots are NaN.
    bpp = tx.padded_breakpoints(card)
    lanes, n_bpp = 32, bpp.numel()
    s_bp = torch.full((257 * lanes,), float("nan"))
    s = torch.arange(n_bpp)[:, None]
    slot = s * lanes + (torch.arange(lanes)[None, :] + s) % lanes
    assert slot.unique().numel() == n_bpp * lanes  # each slot written once
    s_bp[slot.reshape(-1)] = bpp[s].expand(-1, lanes).reshape(-1)
    qps, sax, _ = _edge_inputs("cpu", 8, 333, w, card + w, card=card)
    every = (torch.arange(lanes * card)[:, None] // lanes
             + torch.arange(w)[None, :]) % card
    sax = torch.cat([sax, every.to(torch.uint8)])
    lane = torch.arange(sax.shape[0]) % lanes
    scale = torch.tensor(256 / w, dtype=torch.float32)
    for q in qps:
        for j in range(w):
            at = sax[:, j].long() * lanes + lane
            lo, hi = s_bp[at], s_bp[at + lanes]
            d = torch.clamp_min(torch.maximum(
                (q[j] - hi).view(torch.int32), (lo - q[j]).view(torch.int32)),
                0).view(torch.float32)
            acc = d * d if j == 0 else acc + d * d
        want = tops.lower_bound_sq(q, sax, bpp, 256, impl="ref")
        assert torch.equal(scale * acc, want)


def test_lower_bound_multi_refuses_bad_layouts():
    qp, sax, block_len, block = _packed_case(2, 16)
    bpp = tx.padded_breakpoints()
    with pytest.raises(ValueError, match="multiple of block_n"):
        tops.lower_bound_sq_multi(_t(qp), _t(sax[:-1]), bpp, 256,
                                  _t(block_len), block_n=block)
    with pytest.raises(ValueError, match="block_len has"):
        tops.lower_bound_sq_multi(_t(qp), _t(sax), bpp, 256,
                                  _t(block_len[:-1]), block_n=block)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("rows", [300, 512])
def test_euclid_min_matches_reference(impl, rows):
    data = np.array(_znormed(rows, 256, seed=rows + 33))
    data[rows - 40] = data[17]  # an exact tie: the first row must win
    q = data[17] + np.float32(0.01)
    want_d, want_i = jops.euclid_min(jnp.asarray(q), jnp.asarray(data),
                                     impl=impl, block_b=128)
    got_d, got_i = tops.euclid_min(_t(q), _t(data))
    assert got_i.dtype == torch.int32 and int(got_i) == int(want_i) == 17
    if impl == "ref":
        assert_float_parity(got_d.numpy(), np.asarray(want_d))
    else:
        np.testing.assert_allclose(float(got_d), float(want_d), rtol=1e-6)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_euclid_sq_matches_reference(impl):
    data = _znormed(256, 256, seed=31)
    q = _znormed(1, 256, seed=32)[0]
    want = np.asarray(jops.euclid_sq(jnp.asarray(q), jnp.asarray(data),
                                     impl=impl))
    got = tops.euclid_sq(_t(q), _t(data)).numpy()
    if impl == "ref":
        assert_float_parity(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_euclid_gather_forms_and_clip():
    raw = _t(_znormed(50, 64, seed=41))
    qs = _t(_znormed(3, 64, seed=42))
    pos = torch.tensor([[0, 49, -1, 7], [3, 3, 60, 0], [-5, 1, 2, 49]],
                       dtype=torch.int32)
    got = tops.euclid_sq_gather(qs, raw, pos)
    for i in range(3):
        clipped = pos[i].clamp(0, 49).long()  # take(..., mode="clip")
        np.testing.assert_array_equal(
            got[i].numpy(), tops.euclid_sq(qs[i], raw[clipped]).numpy())
    shared = tops.euclid_sq_gather(qs, raw, pos[1])  # (R,) for every query
    np.testing.assert_array_equal(
        shared.numpy(), tops.euclid_sq_gather(qs, raw, pos[1].expand(3, -1))
        .numpy())


def test_dispatch_rules():
    z = _t(_znormed(16, 64, seed=51))
    bp = tx.gaussian_breakpoints()
    with pytest.raises(ValueError, match="impl"):
        tops.paa_isax(z, bp, 16, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        tops.select(z.abs(), 5, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        tops.lower_bound_sq(z[0, :16], torch.zeros((4, 16), dtype=torch.uint8),
                            tx.padded_breakpoints(), 64, impl="cuda")
    # A CPU tensor never reaches a kernel wrapper: counts stay put.
    tops.reset_launch_counts()
    tops.paa_isax(z, bp, 16)
    tops.euclid_sq(z[0], z)
    tops.euclid_min(z[0], z)
    tops.lower_bound_sq(z[0, :16], torch.zeros((4, 16), dtype=torch.uint8),
                        tx.padded_breakpoints(), 64)
    cols, bounds, _ = tops.select(z.abs(), 5)
    tops.order_range(bounds, cols, 0, 3)
    assert tops.launch_counts() == {
        "paa_isax": 0, "lower_bound_sq_batch": 0, "lower_bound_sq": 0,
        "lower_bound_sq_multi": 0, "euclid_sq": 0, "euclid_min": 0,
        "select": 0, "order_range": 0, "engine_round": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import euclidean, lower_bound, paa_isax, select

    z = _t(_znormed(8, 64, seed=61))
    with pytest.raises(ValueError, match="CUDA"):
        paa_isax.paa_isax_cuda(z, tx.gaussian_breakpoints(), 16, False)
    with pytest.raises(ValueError, match="CUDA"):
        lower_bound.lower_bound_sq_batch_cuda(
            z[:, :16].contiguous(), torch.zeros((4, 16), dtype=torch.uint8),
            tx.padded_breakpoints(), 64)
    with pytest.raises(ValueError, match="CUDA"):
        euclidean.euclid_sq_gather_cuda(z, z, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        lower_bound.lower_bound_sq_cuda(
            z[0, :16].contiguous(), torch.zeros((4, 16), dtype=torch.uint8),
            tx.padded_breakpoints(), 64)
    with pytest.raises(ValueError, match="CUDA"):
        lower_bound.lower_bound_sq_multi_cuda(
            z[:, :16].contiguous(), torch.zeros((128, 16), dtype=torch.uint8),
            tx.padded_breakpoints(), 64, torch.ones(1, dtype=torch.int32), 128)
    with pytest.raises(ValueError, match="CUDA"):
        euclidean.euclid_min_cuda(z[0].contiguous(), z)
    with pytest.raises(ValueError, match="CUDA"):
        select.select_cuda(z, 3)
    with pytest.raises(ValueError, match="CUDA"):
        select.order_range_cuda(z, z.to(torch.int32), 0, 3)


def test_build_sources_exist_and_name_their_entries():
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        assert "Replaces the TPU kernel" in text
    exported = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    for entry in _build._SIGNATURES:
        assert f'extern "C" int {entry}(' in exported


def test_launch_counts_exact_from_several_threads():
    """Every wrapper counts its launches through a lock-guarded counter:
    threads counting at once (pipeline workers, concurrent appenders)
    lose none. Two threads per kernel, each counting 4000 launches, with
    the interpreter switching threads as often as it can."""
    import sys
    import threading

    counters = {name: getattr(mod, attr)
                for name, (mod, attr) in tops.KERNELS.items()}
    assert all(isinstance(c, _build.LaunchCounter) for c in counters.values())
    tops.reset_launch_counts()
    per_thread = 4000
    start = threading.Barrier(2 * len(counters))

    def launch(counter):
        start.wait(timeout=30)
        for _ in range(per_thread):
            counter.add()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, args=(c,))
                   for c in counters.values() for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert tops.launch_counts() == {name: 2 * per_thread for name in counters}
    tops.reset_launch_counts()
    assert set(tops.launch_counts().values()) == {0}

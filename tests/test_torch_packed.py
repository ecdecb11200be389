"""Port parity, the packed multi-component path against repro.core.search.

The golden raw (330 rows) is built once by the reference, cut into three
file-order shards of 110 rows by ``build_sharded_index`` and packed with
``block=128`` by both packages; so every component ends in pad rows, which
sit BETWEEN components in the buffer. The port also runs over the
reference's own packed buffer, carried across by
``convert.packed_from_arrays``.

Positions are exact, distances bitwise where the reference sums like the
port (``reference_sums_like_port``), else to rounding, counters identical
there, else within 1% (at least 2); achieved epsilon with rtol 1e-5 and
atol 1e-6 (see ``test_torch_tiers.py``). The reference's own property holds
in the port too: packed answers over components equal ``exact_knn_batch``
over one build of the concatenation.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as js
from repro.core.index import build_sharded_index as j_shard
from repro_torch import convert
from repro_torch.core import search as ts
from repro_torch.core.index import build_sharded_index as t_shard
from test_torch_search import (assert_count_parity, assert_float_parity,
                               assert_same_answers, fixture_pair)

BLOCK = 128


@functools.lru_cache(maxsize=None)
def packed_pair():
    """(reference components, port components, reference packed, port
    packed, queries, round size) over the golden fixture in 3 shards."""
    j, t, queries, rnd = fixture_pair("golden")
    sj, st = j_shard(j, 3), t_shard(t, 3)
    comps_j = list(zip(sj.shards, sj.offsets))
    comps_t = list(zip(st.shards, st.offsets))
    return (comps_j, comps_t, js.pack_components(comps_j, block=BLOCK),
            ts.pack_components(comps_t, block=BLOCK), queries, rnd)


def test_pack_components_byte_identical():
    _, _, pj, pt, _, _ = packed_pair()
    for name in ("sax", "gpos", "block_len", "raw"):
        got, want = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
    for name in ("num_series", "block", "series_length", "segments",
                 "cardinality"):
        assert getattr(pt, name) == getattr(pj, name), name
    # 3 x 110 rows in blocks of 128: every component ends in 18 pad rows.
    np.testing.assert_array_equal(pt.block_len.numpy(), [110, 110, 110])
    assert (pt.gpos.numpy() == ts.NO_POS).sum() == 3 * 18


def test_pack_one_component_and_default_block():
    comps_j, comps_t, _, pt, _, _ = packed_pair()
    (ix_j, off_j), (ix_t, off_t) = comps_j[1], comps_t[1]
    for got, want in zip(ts.pack_one_component(ix_t, off_t, BLOCK),
                         js.pack_one_component(ix_j, off_j, BLOCK)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert ts.pack_components(comps_t).block == BLOCK == pt.block
    with pytest.raises(ValueError, match="not contiguous"):
        ts.pack_components([comps_t[0], comps_t[2]])


def test_packed_round_trip_is_byte_identical():
    _, _, _, pt, _, _ = packed_pair()
    arrays = convert.packed_to_arrays(pt)
    back = convert.packed_from_arrays(**arrays, device="cpu")
    again = convert.packed_to_arrays(back)
    assert arrays.keys() == again.keys()
    for key, value in arrays.items():
        if isinstance(value, np.ndarray):
            assert value.dtype == again[key].dtype
            np.testing.assert_array_equal(again[key], value)
        else:
            assert again[key] == value


@pytest.mark.parametrize("k", [1, 4, 8])
def test_exact_knn_batch_packed_parity(k):
    _, _, pj, pt, queries, rnd = packed_pair()
    want = js.exact_knn_batch_packed(pj, jnp.asarray(queries), k=k,
                                     round_size=rnd, stats=True)
    assert_same_answers(want, ts.exact_knn_batch_packed(
        pt, queries, k=k, round_size=rnd, stats=True))
    # The same engine over the reference's own buffer, carried across.
    carried = convert.packed_from_arrays(
        np.asarray(pj.sax), np.asarray(pj.gpos), np.asarray(pj.block_len),
        np.asarray(pj.raw), pj.num_series, pj.block, pj.series_length,
        pj.segments, pj.cardinality, device="cpu")
    assert_same_answers(want, ts.exact_knn_batch_packed(
        carried, queries, k=k, round_size=rnd, stats=True))


def test_exact_search_batch_packed_parity_and_refusal():
    _, _, pj, pt, queries, rnd = packed_pair()
    jr = js.exact_search_batch_packed(pj, jnp.asarray(queries),
                                      js.SearchConfig(round_size=rnd))
    tr = ts.exact_search_batch_packed(pt, queries,
                                      ts.SearchConfig(round_size=rnd))
    np.testing.assert_array_equal(tr.position.numpy(), np.asarray(jr.position))
    assert_float_parity(tr.dist_sq.numpy(), np.asarray(jr.dist_sq))
    assert_count_parity(tr.raw_reads.numpy(), jr.raw_reads)
    assert_count_parity(tr.rounds, int(jr.rounds))
    with pytest.raises(ValueError, match="sort=False"):
        ts.exact_search_batch_packed(pt, queries, ts.SearchConfig(sort=False))


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("k", [1, 8])
def test_knn_batch_packed_tiered_parity(k, seeded):
    comps_j, comps_t, pj, pt, queries, rnd = packed_pair()
    seed_j = seed_t = None
    if seeded:
        seed_j = js.packed_seed(comps_j, jnp.asarray(queries))
        seed_t = ts.packed_seed(comps_t, queries)
        np.testing.assert_array_equal(seed_t[1].numpy(), np.asarray(seed_j[1]))
        assert_float_parity(seed_t[0].numpy(), np.asarray(seed_j[0]))
    for tier in ("eps", "mixed"):
        tiers_j = (js.Tier.epsilon(0.1) if tier == "eps" else
                   [js.Tier.exact(), js.Tier.budget(1), js.Tier.epsilon(0.2),
                    js.Tier.budget(2), js.Tier.exact()])
        tiers_t = (ts.Tier.epsilon(0.1) if tier == "eps" else
                   [ts.Tier.exact(), ts.Tier.budget(1), ts.Tier.epsilon(0.2),
                    ts.Tier.budget(2), ts.Tier.exact()])
        jd, jp, ja = js.knn_batch_packed_tiered(
            pj, jnp.asarray(queries), tiers_j, k=k, round_size=rnd,
            seed=seed_j)
        td, tp, ta = ts.knn_batch_packed_tiered(
            pt, queries, tiers_t, k=k, round_size=rnd, seed=seed_t)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
        np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 4])
def test_packed_engine_args_capacity_padded_parity(k):
    # Dead tail blocks (block_len == 0, gpos NO_POS) change no answer, and
    # the args engine matches the reference's over the same padded buffers.
    _, _, pj, pt, queries, rnd = packed_pair()
    extra = 2
    sax = torch.cat([pt.sax, pt.sax.new_zeros((extra * BLOCK, pt.segments))])
    gpos = torch.cat([pt.gpos, pt.gpos.new_full((extra * BLOCK,), -1)])
    block_len = torch.cat([pt.block_len, pt.block_len.new_zeros(extra)])
    statics = dict(block=BLOCK, series_length=pt.series_length,
                   segments=pt.segments, cardinality=pt.cardinality, k=k,
                   round_size=rnd)
    got = ts.packed_engine_args(sax, gpos, block_len, pt.raw,
                                torch.from_numpy(queries), **statics)
    want = js.packed_engine_args(
        jnp.asarray(sax.numpy()), jnp.asarray(gpos.numpy()),
        jnp.asarray(block_len.numpy()), pj.raw, jnp.asarray(queries),
        **statics)
    assert_same_answers(want, got)
    d, p = ts.exact_knn_batch_packed(pt, queries, k=k, round_size=rnd)
    np.testing.assert_array_equal(got[0].numpy(), d.numpy())
    np.testing.assert_array_equal(got[1].numpy(), p.numpy())


@pytest.mark.parametrize("k", [1, 8])
def test_packed_equals_single_build_of_the_concatenation(k):
    _, t, queries, rnd = fixture_pair("golden")
    _, _, _, pt, _, _ = packed_pair()
    d, p = ts.exact_knn_batch_packed(pt, queries, k=k, round_size=rnd)
    d1, p1 = ts.exact_knn_batch(t, queries, k=k, round_size=rnd)
    np.testing.assert_array_equal(p.numpy(), p1.numpy())
    np.testing.assert_array_equal(d.numpy(), d1.numpy())


def test_selection_keeps_pad_rows_last():
    # The packed bounds put +inf rows between components; the int64 key
    # (lb bits << 32) | row orders every finite bound before them.
    _, _, _, pt, queries, _ = packed_pair()
    qs = torch.from_numpy(queries)
    view = ts._packed_view(pt)
    lb = view.lower_bounds(ts.isax.paa(ts.isax.znorm(qs), pt.segments), "auto")
    pads = pt.gpos == ts.NO_POS
    assert torch.isinf(lb[:, pads]).all() and torch.isfinite(lb[:, ~pads]).all()
    cands = ts.CandidateList(lb, lb.shape[1], lb.shape[1], "auto")
    cols, bounds = cands.round(0)
    n_real = int((~pads).sum())
    assert torch.isfinite(bounds[:, :n_real]).all()
    assert torch.isinf(bounds[:, n_real:]).all()
    assert pads[cols[:, n_real:].long()].all()
    # Within the pads, ties keep the lower row first.
    assert (cols[:, n_real + 1:] > cols[:, n_real:-1]).all()


def test_packed_k_beyond_store_gets_sentinels():
    _, _, _, pt, queries, rnd = packed_pair()
    d, p = ts.exact_knn_batch_packed(pt, queries[:2], k=pt.num_series + 3,
                                     round_size=rnd)
    assert torch.isinf(d[:, -3:]).all() and (p[:, -3:] == ts.NO_POS).all()
    assert torch.isfinite(d[:, :pt.num_series]).all()

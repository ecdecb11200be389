"""Port parity, engine entry points and helpers around the exact engine.

Fixtures and the comparison protocol are those of ``test_torch_search.py``
(one identical index under both engines, built from the JAX index's
arrays); this file covers the full-sort selection, the single-query and
1-NN wrappers, the approximate seed, the sentinel protocol and the small
helpers the engine is made of.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as j_build_index
from repro.core import datagen
from repro.core import search as js
from repro_torch.core import search as ts
from test_torch_search import (assert_count_parity, assert_same_answers,
                               fixture_pair, port_index)


@pytest.fixture(scope="module", params=["golden", "noise"])
def pair(request):
    return fixture_pair(request.param)


def test_full_sort_select_parity(pair):
    j, t, queries, rnd = pair
    assert_same_answers(js.exact_knn_batch(j, jnp.asarray(queries), k=4, round_size=rnd,
                             select="sort", stats=True),
          ts.exact_knn_batch(t, queries, k=4, round_size=rnd, select="sort",
                             stats=True))


def test_fallback_runs_on_noise_fixture():
    _, t, queries, rnd = fixture_pair("noise")
    *_, rounds = ts.exact_knn_batch(t, queries, k=1, round_size=rnd,
                                    stats=True)
    assert rounds > -(-ts.select_len(t.num_series, rnd) // rnd)


def test_exact_search_batch_and_single_query_wrappers():
    j, t, queries, rnd = fixture_pair("walk")
    cfg_j = js.SearchConfig(round_size=rnd)
    cfg_t = ts.SearchConfig(round_size=rnd)
    jr = js.exact_search_batch(j, jnp.asarray(queries), cfg_j)
    tr = ts.exact_search_batch(t, queries, cfg_t)
    np.testing.assert_array_equal(tr.position.numpy(), np.asarray(jr.position))
    assert_count_parity(tr.raw_reads.numpy(), jr.raw_reads)
    assert_count_parity(tr.rounds, int(jr.rounds))
    one_j = js.exact_search(j, jnp.asarray(queries[0]), cfg_j)
    one_t = ts.exact_search(t, queries[0], cfg_t)
    assert int(one_t.position) == int(one_j.position)
    np.testing.assert_allclose(float(one_t.dist_sq), float(one_j.dist_sq),
                               rtol=1e-5)
    kd_j, kp_j = js.exact_knn(j, jnp.asarray(queries[1]), k=3, round_size=rnd)
    kd_t, kp_t = ts.exact_knn(t, queries[1], k=3, round_size=rnd)
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))


def test_approx_search_batch_parity(pair):
    j, t, queries, _ = pair
    jd, jp = js.approx_search_batch(j, jnp.asarray(queries), 256)
    td, tp = ts.approx_search_batch(t, queries, 256)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    d0, p0 = ts.approx_search(t, queries[0], 256)
    assert int(p0) == int(tp[0]) and float(d0) == float(td[0])


def test_k_beyond_index_is_sentinel_padded():
    raw = datagen.random_walk(5, 64, seed=3)
    j = j_build_index(jnp.asarray(raw))
    t = port_index(j)
    q = datagen.random_walk(2, 64, seed=4)
    jd, jp = js.exact_knn_batch(j, jnp.asarray(q), k=8, round_size=4)
    td, tp = ts.exact_knn_batch(t, q, k=8, round_size=4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert np.all(tp.numpy()[:, 5:] == ts.NO_POS)
    assert np.all(np.isinf(td.numpy()[:, 5:]))
    with pytest.raises(ValueError, match="k must be"):
        ts.exact_knn_batch(t, q, k=0)


def test_engine_helpers_match_reference():
    for n, rs in ((100, 8), (10 ** 6, 4096), (5000, 64)):
        assert ts.select_len(n, rs) == js.select_len(n, rs)
    for n in (1, 3, 8, 9, 100):
        assert ts.pow2_bucket(n, 4) == js.pow2_bucket(n, 4)
    rng = np.random.default_rng(0)
    cand = rng.integers(0, 20, size=(3, 16)).astype(np.int32)
    top_p = rng.integers(-1, 20, size=(3, 4)).astype(np.int32)
    top_d = np.where(top_p < 0, np.inf, rng.random((3, 4))).astype(np.float32)
    np.testing.assert_array_equal(
        ts.dedup_mask(torch.from_numpy(cand), torch.from_numpy(top_d),
                      torch.from_numpy(top_p)).numpy(),
        np.asarray(js.dedup_mask(jnp.asarray(cand), jnp.asarray(top_d),
                                 jnp.asarray(top_p))))
    d = [np.array([[1.0, 3.0]], np.float32), np.array([[1.0, 2.0]], np.float32)]
    p = [np.array([[4, 9]], np.int32), np.array([[2, 7]], np.int32)]
    for got, want in zip(ts.merge_top_lists(d, p, 3),
                         js.merge_top_lists(d, p, 3)):
        np.testing.assert_array_equal(got, want)


def test_smallest_breaks_ties_toward_lower_column():
    lb = torch.tensor([[3.0, 1.0, 1.0, 0.0, 1.0, float("inf")]])
    cols, bounds = ts.CandidateList(lb, 4, 4, "auto").round(0)
    assert cols.tolist() == [[3, 1, 2, 4]]
    assert bounds.tolist() == [[0.0, 1.0, 1.0, 1.0]]

"""Port parity, the paper's single-query baselines against repro.core.search.

``exact_search_single`` (ParIS+ with the one-query engine: full stable
argsort, rounds against one BSF), ``nb_exact_search`` (nb-ParIS+:
independent workers with local BSFs) and ``brute_force`` (the UCR-Suite
scan) of both packages over one identical index (``convert.index_from_
arrays``, see ``test_torch_search.py``), query by query.

Positions are exact. Distances are bitwise where the reference sums like
the port (``reference_sums_like_port``), else to rounding; ``raw_reads``,
``bsf_updates`` and ``rounds`` are identical there, else within 1% (at
least 2). Each fixture keeps one round size, so the reference compiles few
engines.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import search as js
from repro_torch.core import search as ts
from test_torch_search import (assert_count_parity, assert_float_parity,
                               fixture_pair)

FIXTURES = ["golden", "noise"]


def _same_result(jr, tr):
    assert int(tr.position) == int(jr.position)
    assert_float_parity(tr.dist_sq.numpy(), np.asarray(jr.dist_sq))
    assert_count_parity(int(tr.raw_reads), int(jr.raw_reads))
    assert_count_parity(int(tr.bsf_updates), int(jr.bsf_updates))
    assert_count_parity(tr.rounds, int(jr.rounds))


def test_search_config_fields_match_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(ts.SearchConfig) == fields(js.SearchConfig)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("sort", [True, False])
def test_exact_search_single_parity(name, sort):
    j, t, queries, rnd = fixture_pair(name)
    cfg_j = js.SearchConfig(round_size=rnd, sort=sort)
    cfg_t = ts.SearchConfig(round_size=rnd, sort=sort)
    for q in queries:
        _same_result(js.exact_search_single(j, jnp.asarray(q), cfg_j),
                     ts.exact_search_single(t, q, cfg_t))


def test_exact_search_single_runs_several_rounds():
    # The noise fixture's loose bounds keep the sorted head below the BSF
    # for many rounds, so the host loop's early exit is exercised.
    _, t, queries, rnd = fixture_pair("noise")
    res = ts.exact_search_single(t, queries[0], ts.SearchConfig(round_size=rnd))
    assert 1 < res.rounds < -(-t.num_series // rnd)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("workers", [1, 4, 16])
def test_nb_exact_search_parity(name, workers):
    j, t, queries, rnd = fixture_pair(name)
    cfg_j = js.SearchConfig(round_size=rnd, workers=workers)
    cfg_t = ts.SearchConfig(round_size=rnd, workers=workers)
    for q in queries:
        _same_result(js.nb_exact_search(j, jnp.asarray(q), cfg_j),
                     ts.nb_exact_search(t, q, cfg_t))


@pytest.mark.parametrize("name", FIXTURES)
def test_brute_force_parity(name):
    j, t, queries, _ = fixture_pair(name)
    for q in queries:
        jr = js.brute_force(j, jnp.asarray(q))
        tr = ts.brute_force(t, q)
        _same_result(jr, tr)
        assert int(tr.raw_reads) == t.num_series


def test_baselines_agree_with_each_other_on_ties():
    # The golden fixture holds duplicated rows and a query that is a
    # datastore row: all three algorithms find the same (first) 1-NN.
    _, t, queries, rnd = fixture_pair("golden")
    cfg = ts.SearchConfig(round_size=rnd)
    for q in queries:
        a = ts.exact_search_single(t, q, cfg)
        b = ts.nb_exact_search(t, q, cfg)
        c = ts.brute_force(t, q)
        assert float(a.dist_sq) == float(b.dist_sq) == float(c.dist_sq)


def test_baselines_refuse_a_batch():
    _, t, queries, _ = fixture_pair("golden")
    for fn in (ts.exact_search_single, ts.nb_exact_search, ts.brute_force):
        with pytest.raises(ValueError, match="query must be"):
            fn(t, queries[:2])

"""Port parity, the serving fabric: repro_torch.serving against repro.serving.

The batcher and the sharded router of both packages run over ONE identical
index (the reference builds it; the port gets its arrays through
``convert.index_from_arrays``) and the same numpy queries. Positions,
``NO_POS`` slots and the deterministic ``stats()`` counters (answered,
batches, padded_queries, rejected, shed) must be equal; distances bitwise
where the reference sums like the port (``reference_sums_like_port``),
else within float rounding; achieved epsilon within rtol 1e-5, atol 1e-6.

The reference runs synchronously (``search_batch`` / ``drain``, no
daemons) and its oracles are built once per module: this file runs beside
the reference's own serving tests, whose deadlines sit over JIT compiles.
Every daemon, thread and sleep is on the port's side, and every
``Future.result`` has a timeout.
"""

import functools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as j_build_index
from repro.core import build_sharded_index as j_sharded
from repro.core import search as js
from repro.serving import router as jr
from repro.serving import search_batcher as jb
from repro.serving.util import pow2_bucket as j_pow2_bucket
from repro_torch.core import isax as tx
from repro_torch.core import search as ts
from repro_torch.core.index import build_sharded_index as t_sharded
from repro_torch.serving import router as tr
from repro_torch.serving import search_batcher as tb
from repro_torch.serving.util import pow2_bucket
from test_torch_search import (assert_count_parity, assert_float_parity,
                               port_index)

RNG = np.random.default_rng(2024)
N, LENGTH, ROUND = 300, 64, 128
RAW = RNG.standard_normal((N, LENGTH)).cumsum(axis=1).astype(np.float32)
QS = RNG.standard_normal((16, LENGTH)).cumsum(axis=1).astype(np.float32)
WAIT = 30  # every future's timeout: a hang fails here, loudly
DETERMINISTIC = ("answered", "batches", "padded_queries", "rejected", "shed")
# Routers compared counter for counter flush only full batches in their
# synchronous ``search_batch`` (a partial batch waits for the drain), so
# how the stream is cut does not depend on how long a flush took.
PATIENT_MS = 1e6


@functools.lru_cache(maxsize=None)
def pair():
    """(reference index, the port's index over its arrays)."""
    j = j_build_index(jnp.asarray(RAW))
    return j, port_index(j)


@functools.lru_cache(maxsize=None)
def oracle(k):
    """The reference's exact k-NN of ``QS`` over the whole index."""
    d, p = js.exact_knn_batch(pair()[0], jnp.asarray(QS), k=k,
                              round_size=ROUND)
    return np.asarray(d), np.asarray(p)


@functools.lru_cache(maxsize=None)
def sharded(s_count):
    """The same S-way split in both packages (one object per module, so the
    reference compiles each shard's engine once)."""
    j, t = pair()
    return j_sharded(j, s_count), t_sharded(t, s_count)


def assert_same_knn(got_d, got_p, want_d, want_p):
    np.testing.assert_array_equal(got_p, want_p)
    assert_float_parity(got_d, want_d)


def assert_same_counters(got: dict, want: dict):
    assert {k: got[k] for k in DETERMINISTIC} == {
        k: want[k] for k in DETERMINISTIC}


# ----------------------------------------------------------------- batcher
def _arrivals(mod, index):
    """Burst, trickle and drain arrivals through one batcher; returns the
    futures and the flush answers counted at each step."""
    b = mod.SearchRequestBatcher(index, k=4, max_batch=8, max_wait_ms=50.0,
                                 round_size=ROUND)
    futs = [b.submit(q) for q in QS[:9]]  # burst: flushes a full 8 inline
    steps = [b.stats()["flush_full"]]
    futs += [b.submit(q) for q in QS[9:11]]  # trickle: 3 now pending
    steps.append(b.poll())  # not due yet
    time.sleep(0.06)
    steps.append(b.poll())  # max_wait_ms exceeded -> timeout flush
    futs += [b.submit(q) for q in QS[11:15]]  # tail: answered by drain
    steps += [b.drain(), b.drain()]
    return futs, steps, b.stats()


def test_batcher_mixed_arrival_patterns_match_reference():
    j, t = pair()
    jf, jsteps, jstats = _arrivals(jb, j)
    tf, tsteps, tstats = _arrivals(tb, t)
    assert tsteps == jsteps == [1, 0, 3, 4, 0]
    assert_same_counters(tstats, jstats)
    assert tstats["flush_full"] == tstats["flush_timeout"] == 1
    assert tstats["submitted"] == tstats["answered"] == 15
    assert tstats["latency_ms_max"] >= tstats["latency_ms_avg"] > 0
    want_d, want_p = oracle(4)
    for i, (f, g) in enumerate(zip(tf, jf)):
        d, p = f.result(timeout=WAIT)
        assert isinstance(d, np.ndarray) and isinstance(p, np.ndarray)
        np.testing.assert_array_equal(p, np.asarray(g.result(timeout=WAIT)[1]))
        assert_same_knn(d, p, want_d[i], want_p[i])


def test_batcher_1nn_matches_direct_engine_and_reference():
    j, t = pair()
    cfg = ts.SearchConfig(round_size=ROUND)
    b = tb.SearchRequestBatcher(t, max_batch=4, cfg=cfg)
    futs = [b.submit(q) for q in QS[:5]]  # one full flush of 4 + 1 drained
    b.drain()
    direct = ts.exact_search_batch(t, QS[:5], cfg)
    want = js.exact_search_batch(j, jnp.asarray(QS[:5]),
                                 js.SearchConfig(round_size=ROUND))
    for i, f in enumerate(futs):
        r = f.result(timeout=WAIT)
        assert isinstance(r.position, np.integer)
        assert int(r.position) == int(direct.position[i])
        assert float(r.dist_sq) == float(direct.dist_sq[i])
        assert int(r.raw_reads) == int(direct.raw_reads[i])
        assert int(r.position) == int(want.position[i])
        assert_count_parity(int(r.raw_reads), int(want.raw_reads[i]))


def test_batcher_daemon_flushes_on_timeout():
    b = tb.SearchRequestBatcher(pair()[1], k=2, max_batch=64,
                                max_wait_ms=5.0, round_size=ROUND)
    b.start(tick_ms=2.0)
    try:
        d, p = b.submit(QS[0]).result(timeout=WAIT)  # never fills a batch
    finally:
        b.stop()
    assert d.shape == (2,) and b.stats()["flush_timeout"] == 1
    assert_same_knn(d, p, oracle(2)[0][0], oracle(2)[1][0])


def _admission(mod, index, policy):
    """A saturated queue under ``policy``; returns (futures, outcome of
    each extra submit, stats)."""
    b = mod.SearchRequestBatcher(
        index, k=2, max_batch=4, max_pending=4, policy=policy,
        block_timeout_ms=20.0, inline_flush=False, round_size=ROUND)
    futs, extra = [], []
    for q in QS[:7]:
        try:
            futs.append(b.submit(q))
            extra.append("queued")
        except mod.QueueFullError:
            futs.append(None)
            extra.append("turned away")
    b.drain()
    return futs, extra, b.stats()


@pytest.mark.parametrize("policy", ["reject", "shed-oldest", "block"])
def test_batcher_admission_policies_match_reference(policy):
    j, t = pair()
    jf, jextra, jstats = _admission(jb, j, policy)
    tf, textra, tstats = _admission(tb, t, policy)
    assert textra == jextra
    assert_same_counters(tstats, jstats)
    assert tstats["queue_depth_peak"] == jstats["queue_depth_peak"] == 4
    assert tstats["blocked"] == jstats["blocked"]
    want_d, want_p = oracle(2)
    for i, (f, g) in enumerate(zip(tf, jf)):
        if f is None:
            continue
        if g.exception(timeout=WAIT) is not None:
            assert isinstance(f.exception(timeout=WAIT), tb.RequestShedError)
            continue
        d, p = f.result(timeout=WAIT)
        assert_same_knn(d, p, want_d[i], want_p[i])


def test_batcher_block_policy_daemon_makes_space():
    b = tb.SearchRequestBatcher(
        pair()[1], k=2, max_batch=2, max_pending=2, policy="block",
        max_wait_ms=2.0, inline_flush=False, round_size=ROUND)
    b.start(tick_ms=1.0)
    try:
        futs = [b.submit(q) for q in QS[:8]]  # > max_pending: blocks
        res = [f.result(timeout=WAIT) for f in futs]
    finally:
        b.stop()
    assert b.stats()["answered"] == 8
    for i, (d, p) in enumerate(res):
        assert_same_knn(d, p, oracle(2)[0][i], oracle(2)[1][i])


def test_batcher_validation():
    t = pair()[1]
    with pytest.raises(ValueError):
        tb.SearchRequestBatcher(t, k=0)
    with pytest.raises(ValueError):
        tb.SearchRequestBatcher(t, max_batch=0)
    with pytest.raises(ValueError):
        tb.SearchRequestBatcher(t, policy="drop-newest")
    with pytest.raises(ValueError):  # a bound below max_batch can't fill one
        tb.SearchRequestBatcher(t, max_batch=8, max_pending=4)
    b = tb.SearchRequestBatcher(t, k=1)
    with pytest.raises(ValueError):
        b.submit(QS[:2])  # a (2, n) matrix is not a single query
    with pytest.raises(ValueError, match="k-NN mode"):
        tb.SearchRequestBatcher(t, k=None).submit(
            QS[0], tier=ts.Tier.epsilon(0.1))
    for n, lo in ((1, 1), (5, 1), (3, 4), (64, 1), (65, 1)):
        assert pow2_bucket(n, lo) == j_pow2_bucket(n, lo)
    # A query given as a tensor waits as a host row, like a numpy one.
    f = b.submit(torch.from_numpy(QS[0]))
    b.drain()
    d, p = f.result(timeout=WAIT)
    assert_same_knn(d, p, oracle(1)[0][0], oracle(1)[1][0])


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("s_count", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 8])
def test_router_knn_parity_with_reference_router(s_count, k):
    j_sh, t_sh = sharded(s_count)
    jrt = jr.ShardedSearchRouter(j_sh, k=k, max_batch=5,
                                 max_wait_ms=PATIENT_MS, round_size=ROUND)
    trt = tr.ShardedSearchRouter(t_sh, k=k, max_batch=5,
                                 max_wait_ms=PATIENT_MS, round_size=ROUND)
    qs = QS[:10]  # two cohorts of 5, each padded to 8: one engine shape
    jd, jp = jrt.search_batch(qs)
    td, tp = trt.search_batch(qs)
    assert td.dtype == np.float32 and tp.dtype == np.int32
    np.testing.assert_array_equal(tp, jp)
    assert_float_parity(td, jd)
    assert_same_knn(td, tp, oracle(k)[0][:10], oracle(k)[1][:10])
    assert_same_counters(trt.stats(), jrt.stats())
    assert trt.stats()["padded_queries"] == 2 * 3 * s_count
    assert trt.stats()["merges"] == jrt.stats()["merges"] == 10


def test_router_1nn_parity():
    j, _ = pair()
    _, t_sh = sharded(2)
    got = tr.ShardedSearchRouter(t_sh, k=None, max_batch=4).search_batch(QS)
    want = js.exact_search_batch(j, jnp.asarray(QS))
    np.testing.assert_array_equal(got.position, np.asarray(want.position))
    assert_float_parity(got.dist_sq, np.asarray(want.dist_sq))
    assert got.raw_reads.shape == (len(QS),) and np.all(got.raw_reads > 0)


def test_router_k_exceeds_shard_size():
    # k larger than every shard (4 x 75 rows): each shard's sentinel slots
    # sink in the merge and the global answer is sentinel-free.
    _, t_sh = sharded(4)
    k = 80
    got_d, got_p = tr.ShardedSearchRouter(
        t_sh, k=k, max_batch=4, round_size=ROUND).search_batch(QS[:3])
    want_d, want_p = js.exact_knn_batch(pair()[0], jnp.asarray(QS[:3]), k=k,
                                        round_size=ROUND)
    assert (got_p >= 0).all()
    assert_same_knn(got_d, got_p, np.asarray(want_d), np.asarray(want_p))


def test_router_threaded_daemons_and_clients():
    """Two shards of two replicas, their daemons, and three client
    threads submitting at once: every answer equals the reference's."""
    _, t_sh = sharded(2)
    r = tr.ShardedSearchRouter(t_sh, k=8, replicas=2, max_batch=4,
                               max_wait_ms=3.0, round_size=ROUND)
    r.start(tick_ms=1.0)
    futs = [None] * len(QS)

    def client(c):
        for i in range(c, len(QS), 3):
            futs[i] = r.submit(QS[i])

    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
            assert not th.is_alive()
        res = [f.result(timeout=WAIT) for f in futs]
    finally:
        r.stop()
    assert_same_knn(np.stack([d for d, _ in res]),
                    np.stack([p for _, p in res]), *oracle(8))
    s = r.stats()
    assert s["answered"] == len(QS) * 2 and s["queued"] == 0
    assert s["replicas"] == 2 and s["num_shards"] == 2


def test_router_tier_certificates_match_reference():
    j_sh, t_sh = sharded(2)
    jd, jp, ja = jr.ShardedSearchRouter(
        j_sh, k=8, max_batch=16, round_size=ROUND).search_batch(
            QS, tier=js.Tier.epsilon(0.2))
    r = tr.ShardedSearchRouter(t_sh, k=8, max_batch=16, round_size=ROUND)
    td, tp, ta = r.search_batch(QS, tier=ts.Tier.epsilon(0.2))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-6)
    # The certificate against ground truth: every answered position within
    # (1 + achieved) of the exact distance in the same column.
    t = pair()[1]
    zq = tx.znorm(torch.from_numpy(QS)).numpy().astype(np.float64)
    zr = t.raw.numpy().astype(np.float64)
    true = np.sqrt(((zr[tp] - zq[:, None, :]) ** 2).sum(-1))
    exact = np.sqrt(oracle(8)[0].astype(np.float64))
    assert np.all(ta <= 0.2 + 1e-5)
    assert np.all(true <= (1 + ta[:, None]) * exact * (1 + 1e-4))
    s = r.stats()
    assert s["tiered_answered"] == len(QS) * 2
    assert s["achieved_eps_max"] <= 0.2 + 1e-5 and s["degraded"] == 0


def test_router_degrades_instead_of_shedding():
    # Every deadline below epsilon_slack_ms degrades exact -> epsilon at
    # admission; deadline-less requests never degrade.
    _, t_sh = sharded(2)
    pol = tr.TierDegradePolicy(epsilon_slack_ms=1e6, budget_slack_ms=1.0,
                               epsilon=0.25)
    r = tr.ShardedSearchRouter(t_sh, k=4, max_batch=8, round_size=ROUND,
                               degrade=pol)
    want_d, want_p, want_a = tr.ShardedSearchRouter(
        t_sh, k=4, max_batch=8, round_size=ROUND).search_batch(
            QS, tier=ts.Tier.epsilon(0.25))
    r.start()
    try:
        futs = [r.submit(q, deadline_ms=20_000.0) for q in QS]
        plain = r.submit(QS[0])
        res = [f.result(timeout=WAIT) for f in futs]
        assert len(plain.result(timeout=WAIT)) == 2  # no deadline: exact
    finally:
        r.stop()
    assert all(len(x) == 3 for x in res)
    np.testing.assert_array_equal(np.stack([x[1] for x in res]), want_p)
    np.testing.assert_array_equal(np.stack([x[0] for x in res]), want_d)
    np.testing.assert_array_equal(np.array([x[2] for x in res], np.float32),
                                  want_a)
    s = r.stats()
    assert s["degraded"] == len(QS)
    assert s["tiered_answered"] == len(QS) * 2  # per-shard sub-answers


def test_degrade_policy_matches_reference():
    with pytest.raises(ValueError):
        tr.TierDegradePolicy(budget_slack_ms=0.0)
    with pytest.raises(ValueError):
        tr.TierDegradePolicy(epsilon_slack_ms=5.0, budget_slack_ms=10.0)
    with pytest.raises(ValueError):
        tr.TierDegradePolicy(epsilon=-0.5)
    with pytest.raises(ValueError):
        tr.TierDegradePolicy(budget_rounds=0)
    knobs = dict(epsilon_slack_ms=50.0, budget_slack_ms=10.0, epsilon=0.1,
                 budget_rounds=2)
    jpol, tpol = jr.TierDegradePolicy(**knobs), tr.TierDegradePolicy(**knobs)
    for kind, eps, rounds in (("exact", 0.0, 0), ("epsilon", 0.1, 0),
                              ("epsilon", 0.4, 0), ("budget", 0.0, 2)):
        for slack in (None, 100.0, 30.0, 5.0):
            got = tpol.pick(ts.Tier(kind, eps, rounds), slack)
            want = jpol.pick(js.Tier(kind, eps, rounds), slack)
            assert (got.kind, got.eps, got.budget_rounds) == (
                want.kind, want.eps, want.budget_rounds)


def test_router_refuses_tiers_and_degrade_without_knn_mode():
    _, t_sh = sharded(2)
    with pytest.raises(ValueError, match="k-NN mode"):
        tr.ShardedSearchRouter(t_sh, k=None, degrade=tr.TierDegradePolicy())
    r = tr.ShardedSearchRouter(t_sh, k=None, max_batch=4)
    with pytest.raises(ValueError, match="k-NN mode"):
        r.submit(np.zeros(LENGTH, np.float32), tier=ts.Tier.budget(1))
    with pytest.raises(ValueError):
        tr.ShardedSearchRouter(pair()[1])  # num_shards required
    with pytest.raises(ValueError):
        r.submit(QS[:2])  # a (2, n) matrix is not a single query
    r.stop()


@pytest.mark.parametrize("policy", ["shed-oldest", "reject", "block"])
def test_router_admission_matches_reference(policy):
    """Saturated replica queues, the two packages side by side: the same
    requests shed or turned away, the same counters, exact answers."""
    outcomes = {}
    for name, mod, sh in (("ref", jr, sharded(2)[0]),
                          ("port", tr, sharded(2)[1])):
        r = mod.ShardedSearchRouter(
            sh, k=2, max_batch=4, max_pending=4 if policy != "block" else 8,
            policy=policy, max_wait_ms=PATIENT_MS, round_size=ROUND)
        if policy == "block":  # search_batch must not deadlock without
            outcomes[name] = (r.search_batch(QS), r.stats())  # a daemon
            continue
        futs, raised = [], 0
        for q in QS[:6]:
            try:
                futs.append(r.submit(q))
            except (jb.QueueFullError, tb.QueueFullError):
                raised += 1
        r.drain()
        res = [f.exception(timeout=WAIT) or f.result(timeout=WAIT)
               for f in futs]
        outcomes[name] = (res, raised, r.stats())
    if policy == "block":
        (jd, jp), js_ = outcomes["ref"]
        (td, tp), ts_ = outcomes["port"]
        np.testing.assert_array_equal(tp, jp)
        assert_same_knn(td, tp, *oracle(2))
        assert_same_counters(ts_, js_)
        return
    jres, jraised, jstats = outcomes["ref"]
    tres, traised, tstats = outcomes["port"]
    assert traised == jraised
    assert_same_counters(tstats, jstats)
    want_d, want_p = oracle(2)
    for i, (a, b) in enumerate(zip(tres, jres)):
        if isinstance(b, Exception):
            assert isinstance(a, tb.QueueFullError)
            continue
        assert_same_knn(a[0], a[1], want_d[i], want_p[i])

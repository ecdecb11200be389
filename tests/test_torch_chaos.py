"""Port chaos suite: the serving fabric's contract under injected faults.

The port's side of the reference's ``tests/test_chaos.py`` fault matrix:
replica crash, breaker half-open probe, whole-shard failure, slow replica
and hedging, hedge budget, blackhole and deadline, expiry at submit and in
queue, deadline-aware shedding, a full shard queue, the compaction daemon
killed at ``tick`` and at ``swap``, and a crash-restart mid-ingest through
the port's ``durable.fail_at``. Every future resolves, within its timeout,
to an answer bitwise equal to the reference engine's oracle (built once per
module; distances bitwise where the reference sums like the port, see
``reference_sums_like_port``) or to a typed error. Placement and the
breaker are held against the reference's functions under the same seeded
``random.Random``.
"""

import functools
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build_index as j_build_index
from repro.core import exact_knn_batch as j_exact_knn_batch
from repro.serving import health as jh
from repro_torch.core.durable import FaultError, fail_at
from repro_torch.core.index import build_index, build_sharded_index
from repro_torch.core.ingest import CompactionPolicy, MutableIndex
from repro_torch.serving import health as th
from repro_torch.serving.faults import FaultInjector, InjectedFaultError
from repro_torch.serving.ingest import IngestingRouter
from repro_torch.serving.router import ShardedSearchRouter, ShardFailedError
from repro_torch.serving.search_batcher import (
    DeadlineExceededError, QueueFullError, RequestShedError,
    SearchRequestBatcher,
)
from test_torch_search import assert_float_parity, port_index

RNG = np.random.default_rng(4242)
N, LENGTH, ROUND, K = 300, 64, 128, 4
RAW = RNG.standard_normal((N, LENGTH)).cumsum(axis=1).astype(np.float32)
QUERIES = RNG.standard_normal((6, LENGTH)).cumsum(axis=1).astype(np.float32)
INGEST = RNG.standard_normal((200, LENGTH)).cumsum(axis=1).astype(np.float32)
APPENDS = (40, 30, 35, 25, 20)  # the compaction-kill sequence: 150 series
WAIT = 30  # generous per-future timeout: a hang fails HERE, loudly


@functools.lru_cache(maxsize=None)
def pair():
    """(reference index, the port's index over its arrays)."""
    j = j_build_index(jnp.asarray(RAW))
    return j, port_index(j)


@functools.lru_cache(maxsize=None)
def sharded():
    # One shared 2-way split for every router in the module.
    return build_sharded_index(pair()[1], 2)


@functools.lru_cache(maxsize=None)
def oracle():
    d, p = j_exact_knn_batch(pair()[0], jnp.asarray(QUERIES), k=K,
                             round_size=ROUND)
    return np.asarray(d), np.asarray(p)


@functools.lru_cache(maxsize=None)
def ingest_oracle(n):
    """The reference's answers over a one-shot build of INGEST[:n]."""
    idx = j_build_index(jnp.asarray(INGEST[:n]))
    d, p = j_exact_knn_batch(idx, jnp.asarray(QUERIES), k=K,
                             round_size=ROUND)
    return np.asarray(d), np.asarray(p)


def assert_exact(d, p, want):
    np.testing.assert_array_equal(p, want[1])
    assert_float_parity(d, want[0])


def _router(inj=None, **kw):
    kw.setdefault("k", K)
    kw.setdefault("replicas", 2)
    kw.setdefault("round_size", ROUND)
    return ShardedSearchRouter(sharded(), fault_injector=inj, **kw)


def _answers(router, deadline_ms=None):
    futs = [router.submit(q, deadline_ms=deadline_ms) for q in QUERIES]
    res = [f.result(timeout=WAIT) for f in futs]
    return np.stack([r[0] for r in res]), np.stack([r[1] for r in res])


def _warm(router):
    """Keep first-call costs out of fault and deadline windows."""
    for f in [router.submit(q) for q in QUERIES]:
        f.result(timeout=WAIT)


def _downs(router):
    return {(h["sid"], rep["rid"]): rep
            for h in router.stats()["health"] for rep in h["replicas"]}


# ------------------------------------------------------- replica rerouting
def test_replica_groups_bit_exact():
    r = _router()
    r.start()
    try:
        assert_exact(*_answers(r), oracle())
        s = r.stats()
        assert s["replicas"] == 2 and s["num_shards"] == 2
    finally:
        r.stop()


def test_replica_crash_rerouted_bit_exact():
    """A persistently failing replica is retried around, then breakered."""
    inj = FaultInjector()
    r = _router(inj, down_after=2, probe_after_ms=60_000.0)
    r.start()
    try:
        inj.fail_replica(0, 0)  # every flush on shard 0 / replica 0 dies
        for _ in range(3):  # after the breaker opens, placement avoids it
            assert_exact(*_answers(r), oracle())
        assert r.stats()["retries"] >= 1
        downs = _downs(r)
        assert downs[(0, 0)]["down"] and not downs[(0, 1)]["down"]
        assert not downs[(1, 0)]["down"]
        assert inj.fired()["replica:0:0:fail"] >= 1
    finally:
        r.stop()


def test_breaker_half_open_probe_recovers():
    """A healed replica is probed back into rotation, not banned forever."""
    inj = FaultInjector()
    r = _router(inj, down_after=1, probe_after_ms=50.0)
    r.start()
    try:
        inj.fail_replica(0, 0)
        _answers(r)
        assert _downs(r)[(0, 0)]["down"]
        inj.heal_replica(0, 0)
        time.sleep(0.08)  # past probe_after_ms: the next placement may probe
        give_up = time.monotonic() + WAIT
        while time.monotonic() < give_up:
            assert_exact(*_answers(r), oracle())
            if not _downs(r)[(0, 0)]["down"]:
                break
            time.sleep(0.06)
        h = _downs(r)[(0, 0)]
        assert not h["down"], "probe never closed the breaker"
        assert h["successes"] >= 1
    finally:
        r.stop()


def test_whole_shard_failure_is_typed():
    """Every replica of one shard dead: a ShardFailedError naming the
    shard, its cause the injected fault; never a hang or a truncated
    merge."""
    inj = FaultInjector()
    r = _router(inj)
    r.start()
    try:
        _warm(r)
        inj.fail_replica(1)  # rid=None: the whole shard group
        f = r.submit(QUERIES[0])
        with pytest.raises(ShardFailedError) as ei:
            f.result(timeout=WAIT)
        assert ei.value.sid == 1 and "shard 1" in str(ei.value)
        assert isinstance(ei.value.__cause__, InjectedFaultError)
        assert r.stats()["shard_failures"] >= 1
    finally:
        r.stop()


# ------------------------------------------------------------ slow replica
def test_slow_replica_hedged_bit_exact():
    inj = FaultInjector()
    r = _router(inj, hedge_ms=10.0, hedge_budget=1.0)
    r.start()
    try:
        _warm(r)
        inj.slow_replica(0, 0, ms=400.0)
        assert_exact(*_answers(r), oracle())
        s = r.stats()
        assert s["hedges"] >= 1
        assert s["hedges_won"] >= 1  # a hedge beat the 400 ms replica
    finally:
        r.stop()


def test_hedge_budget_bounds_hedge_rate():
    """Issued hedges never exceed budget * sub-queries + burst, however
    hot the trigger."""
    inj = FaultInjector()
    r = _router(inj, hedge_ms=0.0, hedge_budget=0.1, hedge_burst=2)
    r.start()
    try:
        _warm(r)
        inj.slow_replica(0, ms=30.0)
        inj.slow_replica(1, ms=30.0)
        for _ in range(4):
            assert_exact(*_answers(r), oracle())
        s = r.stats()
        assert s["hedges"] <= 0.1 * s["shard_requests"] + 2 + 1
        assert s["hedges_denied"] >= 1  # the trigger really was hot
    finally:
        r.stop()


# -------------------------------------------------- blackholes + deadlines
def test_blackhole_fails_deadline_not_hangs():
    """An accepted-then-lost cohort fails with DeadlineExceededError at the
    deadline, from the router's reaper."""
    inj = FaultInjector()
    r = _router(inj, retry_failures=False)
    r.start()
    try:
        _warm(r)
        inj.blackhole_replica(0)  # both replicas of shard 0 swallow work
        t0 = time.monotonic()
        f = r.submit(QUERIES[0], deadline_ms=250.0)
        with pytest.raises(DeadlineExceededError):
            f.result(timeout=WAIT)
        assert time.monotonic() - t0 < WAIT / 2  # the reaper, not the cap
        s = r.stats()
        assert s["deadline_expired"] >= 1 and s["blackholed"] >= 1
    finally:
        r.stop()


def test_expired_deadline_fails_at_submit():
    r = _router()
    try:
        f = r.submit(QUERIES[0], deadline_ms=0.0)
        with pytest.raises(DeadlineExceededError):
            f.result(timeout=WAIT)
    finally:
        r.stop()


def test_deadline_shedding_drops_least_slack():
    """Admission sheds by time-to-deadline, not queue age, with the typed
    RequestShedError eviction subtype."""
    b = SearchRequestBatcher(pair()[1], k=K, max_batch=4, max_pending=4,
                             policy="shed-oldest", inline_flush=False,
                             round_size=ROUND)
    qs = QUERIES
    f_old = b.submit(qs[0])  # oldest, but unbounded slack
    f_loose = b.submit(qs[1], deadline=time.monotonic() + 60.0)
    f_tight = b.submit(qs[2], deadline=time.monotonic() + 0.050)
    f_mid = b.submit(qs[3], deadline=time.monotonic() + 30.0)
    b.submit(qs[4])  # overflows the queue: someone must go
    with pytest.raises(RequestShedError):
        f_tight.result(timeout=WAIT)
    assert isinstance(f_tight.exception(), QueueFullError)  # typed subtype
    b.drain()
    for i, f in ((0, f_old), (1, f_loose), (3, f_mid)):
        d, p = f.result(timeout=WAIT)
        assert_exact(d, p, (oracle()[0][i], oracle()[1][i]))
    assert b.stats()["shed"] == 1


def test_expired_requests_fail_instead_of_searching():
    b = SearchRequestBatcher(pair()[1], k=K, max_batch=4, round_size=ROUND)
    f = b.submit(QUERIES[0], deadline=time.monotonic() + 0.001)
    time.sleep(0.02)
    b.drain()
    with pytest.raises(DeadlineExceededError):
        f.result(timeout=WAIT)
    s = b.stats()
    assert s["expired"] == 1 and s["batches"] == 0


# ------------------------------------------------------- partial admission
def test_full_shard_queue_names_shard_and_counts_retry():
    """A door-step reject is retried on the sibling replica; when every
    replica is full the raised error names the losing shard."""
    r = _router(max_pending=2, max_batch=2, policy="reject")
    try:
        for q in QUERIES[:2]:  # fill both replicas of both shards
            r.submit(q)
            r.submit(q)
        with pytest.raises(QueueFullError) as ei:
            r.submit(QUERIES[2])
        assert "shard 0" in str(ei.value)
        assert r.stats()["admission_retries"] >= 1
        r.drain()
    finally:
        r.stop()


# ------------------------------------------------------- compaction chaos
def _ingesting(workdir=None, inj=None, **kw):
    kw.setdefault("k", K)
    kw.setdefault("round_size", ROUND)
    kw.setdefault("compact_tick_ms", 10.0)
    return IngestingRouter(
        None, 2, series_length=LENGTH, workdir=workdir, fault_injector=inj,
        compaction_policy=CompactionPolicy(max_deltas=2), device="cpu", **kw)


def _wait_for(cond):
    give_up = time.monotonic() + WAIT
    while not cond() and time.monotonic() < give_up:
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("point,kills", [("swap", 1), ("tick", 3)])
def test_compaction_daemon_killed_survives_and_reconciles(point, kills):
    """``swap``: the fold is published but the daemon dies before the
    router rewire; the old components keep serving (still exact) and the
    next tick's reconcile completes the swap. ``tick``: the daemon backs
    off and survives every kill, then compacts. Nothing double-covered,
    nothing lost."""
    inj = FaultInjector()
    ir = _ingesting(inj=inj)
    inj.kill_compaction(point=point, times=kills)
    ir.start()
    try:
        o = 0
        for sz in APPENDS:
            ir.append(INGEST[o: o + sz])
            o += sz
        assert _wait_for(lambda: ir.stats()["compaction_failures"] >= kills)
        assert "InjectedFaultError" in ir.stats()["last_compaction_error"]
        assert _wait_for(lambda: ir.stats()["ingest"]["compactions"] >= 1)
        # duplicated positions would show a double-covered range
        assert_exact(*_answers(ir), ingest_oracle(o))
    finally:
        ir.stop()


# ----------------------------------------------------------- crash-restart
def test_crash_restart_mid_ingest_resumes_serving(tmp_path):
    """A crash mid-ingest (``fail_at``) loses nothing acknowledged: an
    IngestingRouter over the workdir recovers the committed store and
    serves it bit-exactly, and stays writable."""
    workdir = str(tmp_path / "store")
    m = MutableIndex(series_length=LENGTH, workdir=workdir,
                     fault=fail_at(25), device="cpu")
    acked = 0
    try:
        for sz in (50, 40, 30, 40, 40):
            m.append(INGEST[acked: acked + sz])
            acked += sz
            m.compact(tier="minor")
    except FaultError:
        pass  # the "crash"
    committed = MutableIndex.recover(workdir, device="cpu").num_series
    assert 0 < committed <= acked  # something acknowledged, then killed
    ir = IngestingRouter(None, 2, workdir=workdir, k=K, round_size=ROUND,
                         compaction_policy=None, device="cpu")
    try:
        assert ir.num_series == committed  # zero acknowledged loss
        assert_exact(*ir.search_batch(QUERIES), ingest_oracle(committed))
        ir.append(INGEST[committed: committed + 20])
        assert ir.num_series == committed + 20
    finally:
        ir.stop()


def test_restart_command_equals_cold_start_command(tmp_path):
    """base=None over a workdir that holds a store recovers it; a non-None
    base over a committed store is a loud error."""
    workdir = str(tmp_path / "store")
    ir = IngestingRouter(None, 2, series_length=LENGTH, workdir=workdir,
                         k=K, round_size=ROUND, compaction_policy=None,
                         device="cpu")
    ir.append(INGEST[:150])
    ir.stop()
    ir2 = IngestingRouter(None, 2, workdir=workdir, k=K, round_size=ROUND,
                          compaction_policy=None, device="cpu")
    try:
        assert ir2.num_series == 150
        assert_exact(*ir2.search_batch(QUERIES), ingest_oracle(150))
    finally:
        ir2.stop()
    with pytest.raises(ValueError, match="recover"):
        IngestingRouter(build_index(INGEST[:150], device="cpu"), 2,
                        workdir=workdir)


# ---------------------------------------------- placement and the breaker
class _FakeReplica:
    def __init__(self, health_mod, rid, depth, healthy=True):
        self.rid = rid
        self._depth = depth
        self.health = health_mod.ReplicaHealth(down_after=1)
        if not healthy:
            self.health.record_failure()

    def queue_depth(self):
        return self._depth


def _fleet(health_mod, layout):
    return [_FakeReplica(health_mod, rid, depth, ok)
            for rid, (depth, ok) in enumerate(layout)]


@pytest.mark.parametrize("seed", [0, 7])
def test_choose_replica_matches_reference(seed):
    layouts = ([(5, True), (0, False), (2, True)],
               [(3, True), (3, True), (1, True), (0, True), (4, False)],
               [(1, False), (0, False)])
    for layout in layouts:
        jf, tf = _fleet(jh, layout), _fleet(th, layout)
        jrng, trng = random.Random(seed), random.Random(seed)
        for exclude in ((), (0,), (2,), (0, 2), tuple(range(len(layout)))):
            for _ in range(8):
                want = jh.choose_replica(jf, exclude=exclude, rng=jrng)
                got = th.choose_replica(tf, exclude=exclude, rng=trng)
                assert (got is None) == (want is None)
                if got is not None:
                    assert got.rid == want.rid
    reps = _fleet(th, [(5, True), (0, False), (2, True)])
    assert th.choose_replica(reps).rid == 2  # healthy beats shortest-but-down
    assert th.choose_replica(reps, exclude=(0, 1, 2)) is None


def _breaker_trace(health_mod):
    h = health_mod.ReplicaHealth(down_after=2, probe_after_ms=30.0,
                                 ewma_alpha=0.5)
    far = time.monotonic() + 3600.0  # long past any probe window
    trace = [h.healthy()]
    h.record_success(4.0)
    h.record_failure()
    trace += [h.healthy(), h.down]
    h.record_failure()
    trace += [h.down, h.healthy()]  # breaker open
    trace += [h.healthy(now=far), h.healthy(now=far)]  # one probe, then no
    h.record_failure()  # the probe failed: re-opened
    trace += [h.down, h.healthy(now=far)]
    h.record_success(8.0)
    trace += [h.down, h.healthy(), h.ewma_ms]
    snap = h.snapshot()
    return trace, snap


def test_breaker_matches_reference():
    got, got_snap = _breaker_trace(th)
    want, want_snap = _breaker_trace(jh)
    assert got == want
    assert got_snap == want_snap
    assert got[:9] == [True, True, False, True, False, True, False, True,
                       True]

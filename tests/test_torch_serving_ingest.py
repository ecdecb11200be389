"""Port parity, ingest-while-serving: repro_torch.serving.ingest against
repro.serving.ingest.

``IngestingRouter`` of both packages over one identical base index (the
reference builds it; the port gets its arrays) under the same appends and
folds: positions exact, distances bitwise where the reference sums like
the port (``reference_sums_like_port``), the same shard counts and the
same deterministic counters. The reference runs synchronously; daemons,
client threads and the cold tier's store (under ``tmp_path``) are on the
port's side, held to the reference's answers over one-shot builds of the
same series (built once per module).
"""

import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build_index as j_build_index
from repro.core import exact_knn_batch as j_exact_knn_batch
from repro.core import exact_search_batch as j_exact_search_batch
from repro.serving.ingest import IngestingRouter as JIngestingRouter
from repro_torch.core.ingest import CompactionPolicy, MutableIndex
from repro_torch.serving.ingest import IngestingRouter
from test_torch_search import assert_float_parity, port_index

RNG = np.random.default_rng(77)
LENGTH, ROUND, N_BASE = 64, 128, 220
APPENDS = (61, 40, 23)  # deliberately ragged sizes
RAW = RNG.standard_normal(
    (N_BASE + sum(APPENDS), LENGTH)).cumsum(axis=1).astype(np.float32)
QUERIES = RNG.standard_normal((4, LENGTH)).cumsum(axis=1).astype(np.float32)
BOUNDS = tuple(N_BASE + sum(APPENDS[:i]) for i in range(len(APPENDS) + 1))
WAIT = 30
PATIENT_MS = 1e6  # synchronous routers flush only full batches


@functools.lru_cache(maxsize=None)
def base_pair():
    """(reference base index, the port's index over its arrays)."""
    j = j_build_index(jnp.asarray(RAW[:N_BASE]))
    return j, port_index(j)


@functools.lru_cache(maxsize=None)
def oracle(n, k=4):
    """The reference's exact k-NN over a one-shot build of RAW[:n]."""
    d, p = j_exact_knn_batch(j_build_index(jnp.asarray(RAW[:n])),
                             jnp.asarray(QUERIES), k=k, round_size=ROUND)
    return np.asarray(d), np.asarray(p)


def assert_exact(d, p, want):
    np.testing.assert_array_equal(p, want[1])
    assert_float_parity(d, want[0])


def _grow(svc):
    """The fixed append sequence, with a full fold after the second."""
    o = N_BASE
    for i, a in enumerate(APPENDS):
        svc.append(RAW[o: o + a])
        o += a
        if i == 1:
            svc.compact_now()  # mid-sequence compaction
    return o


@pytest.mark.parametrize("s_count", [1, 2])
@pytest.mark.parametrize("k", [1, 4])
def test_ingesting_router_matches_reference(s_count, k):
    j, t = base_pair()
    knobs = dict(k=k, max_batch=len(QUERIES), max_wait_ms=PATIENT_MS,
                 round_size=ROUND, compaction_policy=None)
    ref = JIngestingRouter(j, s_count, **knobs)
    port = IngestingRouter(t, s_count, **knobs)
    assert _grow(ref) == _grow(port) == BOUNDS[-1]
    for step in ("appended", "folded"):
        jd, jp = ref.search_batch(QUERIES)
        td, tp = port.search_batch(QUERIES)
        np.testing.assert_array_equal(tp, np.asarray(jp))
        assert_float_parity(td, np.asarray(jd))
        if k == 4:
            assert_exact(td, tp, oracle(BOUNDS[-1]))
        if step == "appended":  # compact the tail and re-check
            assert ref.compact_now() is not None
            assert port.compact_now() is not None
    js_, ts_ = ref.stats(), port.stats()
    for key in ("num_shards", "retired_shards", "answered", "batches",
                "padded_queries", "rejected", "shed"):
        assert ts_[key] == js_[key], key
    assert ts_["num_shards"] == s_count
    assert ts_["ingest"]["compactions"] == js_["ingest"]["compactions"] == 2
    assert port.num_series == ref.num_series == BOUNDS[-1]


def test_ingesting_router_1nn_parity():
    svc = IngestingRouter(base_pair()[1], 2, k=None, max_batch=4,
                          compaction_policy=None)
    o = N_BASE
    for a in APPENDS[:2]:
        svc.append(RAW[o: o + a])
        o += a
    got = svc.search_batch(QUERIES)
    want = j_exact_search_batch(j_build_index(jnp.asarray(RAW[:o])),
                                jnp.asarray(QUERIES))
    np.testing.assert_array_equal(got.position, np.asarray(want.position))
    assert_float_parity(got.dist_sq, np.asarray(want.dist_sq))


def test_live_ingest_answers_match_some_prefix():
    """Under concurrent appends and the compaction daemon, every streamed
    answer equals the exact answer over SOME append prefix."""
    oracles = [oracle(n) for n in BOUNDS]
    svc = IngestingRouter(
        base_pair()[1], 2, k=4, replicas=2, max_batch=2, max_wait_ms=2.0,
        round_size=ROUND, compaction_policy=CompactionPolicy(max_deltas=2),
        compact_tick_ms=2.0)
    svc.start()
    errs = []

    def feeder():
        o = N_BASE
        try:
            for a in APPENDS:
                svc.append(RAW[o: o + a])
                o += a
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    t = threading.Thread(target=feeder)
    t.start()
    answers = []
    try:
        for _ in range(12):
            futs = [svc.submit(q) for q in QUERIES[:2]]
            answers.append([f.result(timeout=WAIT) for f in futs])
        t.join(timeout=WAIT)
        assert not t.is_alive()
    finally:
        svc.stop(compact=True)
    assert not errs
    # Each query on its own: an append may land between two submits.
    for ans in answers:
        for i, (got_d, got_p) in enumerate(ans):
            assert any(np.array_equal(got_p, op[i]) and np.array_equal(
                got_d, od[i]) for od, op in oracles), \
                f"answer to query {i} matches no append-prefix oracle"
    assert svc.mutable.num_deltas == 0  # the final fold took every delta
    assert svc.num_series == BOUNDS[-1]
    assert_exact(*svc.search_batch(QUERIES), oracles[-1])


def test_router_swap_is_atomic_under_queries():
    """Submits hammer the router while compactions rewire the shard set:
    no answer may mix the old and the new view."""
    svc = IngestingRouter(base_pair()[1], 2, k=4, max_batch=2,
                          max_wait_ms=1.0, round_size=ROUND,
                          compaction_policy=None)
    _grow(svc)  # leaves one delta for the compactor below
    want = oracle(BOUNDS[-1])
    svc.start()
    stop = threading.Event()
    errs = []

    def compactor():
        try:
            svc.compact_now()  # the one real fold, then no-ops
            while not stop.wait(0.001):  # a spin would starve the daemons
                svc.compact_now()
        except Exception as e:  # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=compactor)
    t.start()
    try:
        for _ in range(10):
            outs = [f.result(timeout=WAIT)
                    for f in [svc.submit(q) for q in QUERIES]]
            assert_exact(np.stack([d for d, _ in outs]),
                         np.stack([p for _, p in outs]), want)
    finally:
        stop.set()
        t.join(timeout=WAIT)
        svc.stop()
    assert not errs and not t.is_alive()
    assert svc.stats()["retired_shards"] > 0


def test_cold_shards_are_routed(tmp_path):
    """A demoted store behind the router: the cold shard answers through
    its disk-backed engine beside the live deltas, exactly."""
    m = MutableIndex(base_pair()[1], workdir=str(tmp_path / "store"),
                     device="cpu")
    o = N_BASE
    for a in APPENDS[:2]:
        m.append(RAW[o: o + a])
        o += a
    m.compact("minor")
    assert m.demote().cold is not None  # base + run -> one cold epoch
    svc = IngestingRouter(m, 2, k=4, max_batch=4, round_size=ROUND,
                          compaction_policy=None)
    svc.append(RAW[o: o + APPENDS[2]])
    s = svc.stats()
    assert s["ingest"]["num_cold"] == 1 and s["num_shards"] == 2
    assert_exact(*svc.search_batch(QUERIES), oracle(BOUNDS[-1]))
    assert svc.stats()["ingest"]["cold_cache"]["misses"] > 0


def test_workdir_with_mutable_base_is_refused(tmp_path):
    m = MutableIndex(series_length=LENGTH, device="cpu")
    with pytest.raises(ValueError, match="workdir cannot be combined"):
        IngestingRouter(m, 1, workdir=str(tmp_path / "w"))
    with pytest.raises(ValueError, match="num_base_shards"):
        IngestingRouter(m, 0)

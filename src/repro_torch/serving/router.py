"""Fault-tolerant sharded search router: replicas, deadlines, hedging.

The single-host analogue of ``core.distributed.make_distributed_batch_search``
— ParIS+'s query answering distributes exact search across workers over a
partitioned index, and this is that shape served from threads — hardened
into a serving *fabric* that survives the failures parallelism multiplies
(a dead engine, a slow thread, a full queue must degrade one sub-query,
not the fleet):

  * the datastore is split into self-contained file-order shards
    (:func:`repro_torch.core.index.build_sharded_index`; a shard's raw
    rows are a view of the index's, not a copy); each shard is served by a
    **replica group** of R interchangeable replicas — same immutable shard
    index and ONE engine shared by the group (the engine keeps no state
    between calls, so daemon threads may run it at once), but each replica
    has its own admission-controlled
    :class:`~repro_torch.serving.search_batcher.SearchRequestBatcher` and its
    own daemon flusher. Placement is least-queue-depth with
    power-of-two-choices sampling over the replicas the per-replica
    health breaker (``serving.health``) considers live, so a dead or
    degraded replica is routed *around* instead of failing the query;
  * ``submit(query, deadline_ms=...)`` fans the query out to ONE replica
    per shard and returns ONE future; when the last shard resolves, the
    per-shard (k,) top lists are merged into the global answer on the
    answering thread (the shared :func:`repro_torch.core.search.merge_top_lists`
    protocol over ownership-disjoint partitions — concat + stable
    k-smallest, positions translated by shard offsets);
  * **end-to-end deadlines**: ``deadline_ms`` rides into every replica
    queue (deadline-aware shedding drops by time-to-deadline, not queue
    age; an expired request is failed, not searched) and a router-side
    reaper fails the merged future with
    :class:`~repro_torch.serving.search_batcher.DeadlineExceededError` the
    instant the deadline passes — a blackholed replica produces a typed
    error at the deadline, never a hang;
  * **hedged / retried fan-out**: a sub-query that fails with a typed
    replica fault is re-issued once on a sibling replica (never for a
    shed — re-amplifying shed load melts an overloaded fleet), and a
    sub-query that is merely *slow* is hedged: after ``hedge_ms`` (or an
    EWMA-scaled trigger with ``hedge_ms="auto"``) the router re-issues it
    on a sibling and takes whichever answer lands first, so one slow
    replica stops defining p99. Hedges spend from a budget
    (``hedge_budget`` x sub-queries + ``hedge_burst``) so hedging cannot
    double the load on a fleet that is slow because it is saturated;
  * failure taxonomy (what a merged future can carry):
    :class:`~repro_torch.serving.search_batcher.QueueFullError` — admission
    turned the request away (the message names the losing shard;
    door-step rejects are retried once on a sibling first);
    :class:`~repro_torch.serving.search_batcher.DeadlineExceededError` — the
    end-to-end deadline passed; :class:`ShardFailedError` — every attempt
    at one shard failed (``.sid`` names it, ``__cause__`` keeps the last
    replica error). Anything else is a router bug, surfaced loudly;
  * the shard set is DYNAMIC: :meth:`add_shard` attaches a new file-range
    shard (a whole replica group) to a running router, and
    :meth:`swap_shards` atomically retires shards and registers their
    replacements — the live-ingest path registers delta shards and swaps
    compacted components without blocking queries. Every query fans out
    over one consistent shard-set snapshot (a reader/writer lock:
    submits share, swaps exclude); retired replicas are flagged so late
    retries/hedges skip them, and each drains everything it accepted
    before detaching;
  * chaos instrumentation: a ``fault_injector``
    (:class:`~repro_torch.serving.faults.FaultInjector`) hooks every replica's
    flush path — injected failures, latency, blackholes — driving the
    chaos suite's contract: under any fault schedule, every answer is
    bit-exact or a typed error, and no future hangs.

  * **service tiers + deadline-slack degradation**: ``submit(q,
    tier=Tier.epsilon(0.05))`` threads the request's tier
    (:class:`~repro_torch.core.search.Tier`) into every replica queue; each
    shard answers at that tier and reports its achieved error bound, and
    the countdown merge combines bounds conservatively (per-query MAX —
    sound because the global k-th best distance is <= every shard's, so
    each shard's certificate holds a fortiori for the merged list). With
    a :class:`TierDegradePolicy`, a deadline-bearing request whose
    time-to-deadline slack is below the policy's thresholds is admitted
    at a CHEAPER tier (``exact -> epsilon -> budget``, never upgraded)
    instead of being shed or expiring in queue — overload turns into
    degraded answers with explicit ``degraded`` / ``achieved_eps_*``
    counters in :meth:`stats`, rather than into errors.

Exactness: every shard scans (and prunes) only its own partition, and the
union of partitions is the datastore, so the merged k-NN list is exactly
the single-index answer — replicas of a shard hold the SAME immutable
index, so WHICH replica answers (primary, retry, or hedge) cannot change
a single bit of the result. Tiered requests trade exactness for latency
*with a certificate*: the merged answer is within ``(1+eps)`` of exact
for the epsilon tier, and carries the achieved bound for the budget tier.

On the card: queries wait and merge on the host, as numpy rows; each
replica's cohort goes to the device in one upload and comes back in one
copy (``serving.search_batcher``), so the merges (``_merge_knn``,
``_merge_1nn``, ``_global_pos``) are host numpy over numpy rows. Every
replica launches on the device's default stream.

This is the JAX package's ``repro.serving.router`` over the port's
engines, with the same names, counters and ``stats()`` keys.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.coldtier import ColdShard, make_cold_batch_engine
from repro_torch.core.index import (
    ParISIndex, ShardedIndex, build_sharded_index,
)
from repro_torch.core.search import (
    NO_POS, SearchConfig, SearchResult, Tier, as_tier, make_batch_engine,
    merge_top_lists,
)
from repro_torch.serving.health import ReplicaHealth, choose_replica
from repro_torch.serving.search_batcher import (
    DeadlineExceededError, QueueFullError, RequestShedError,
    SearchRequestBatcher, host_rows,
)

_NO_POS = int(NO_POS)


class ShardFailedError(RuntimeError):
    """Every attempt at one shard failed; the merged answer is lost.

    ``sid`` names the losing shard (a partial failure is attributable,
    not anonymous); ``__cause__`` carries the last underlying replica
    error.
    """

    def __init__(self, sid: int, message: str):
        super().__init__(message)
        self.sid = sid


_TIER_RANK = {"exact": 0, "epsilon": 1, "budget": 2}


@dataclasses.dataclass(frozen=True)
class TierDegradePolicy:
    """Deadline-slack degradation ladder: answer cheaper, not never.

    When a request arrives with a deadline whose remaining slack is below
    ``epsilon_slack_ms``, it is admitted at the epsilon tier; below
    ``budget_slack_ms`` (the tighter threshold), at the budget tier. A
    request is only ever moved DOWN the ladder (``exact -> epsilon ->
    budget``); a caller that already asked for a cheap tier keeps it.
    Requests without a deadline are never degraded — slack is the signal.

    The point: under overload the fabric protects itself by shedding
    or expiring the queries it cannot answer in time. With a degrade
    policy those same queries are answered *approximately, with a
    certificate* (the achieved bound rides back on the result), which is
    strictly more useful than a typed error when the caller can tolerate
    bounded error. Each degradation increments the router's ``degraded``
    counter.
    """

    epsilon_slack_ms: float = 50.0
    budget_slack_ms: float = 10.0
    epsilon: float = 0.05
    budget_rounds: int = 1

    def __post_init__(self):
        if not self.budget_slack_ms > 0:
            raise ValueError("budget_slack_ms must be > 0")
        if self.epsilon_slack_ms < self.budget_slack_ms:
            raise ValueError(
                "epsilon_slack_ms must be >= budget_slack_ms (the ladder "
                "degrades further as slack shrinks)")
        # Delegate tier-parameter validation to the tier constructors.
        Tier.epsilon(self.epsilon)
        Tier.budget(self.budget_rounds)

    def pick(self, tier: Tier, slack_ms: Optional[float]) -> Tier:
        """The tier to admit at, given the requested tier and the slack.

        Never upgrades: the returned tier is the max (cheapest) of the
        requested tier and what the slack calls for.
        """
        if slack_ms is None:
            return tier
        if slack_ms < self.budget_slack_ms:
            want = Tier.budget(self.budget_rounds)
        elif slack_ms < self.epsilon_slack_ms:
            want = Tier.epsilon(self.epsilon)
        else:
            return tier
        return want if _TIER_RANK[want.kind] > _TIER_RANK[tier.kind] else tier


class _RWLock:
    """Tiny writer-priority reader/writer lock: submits share, swaps exclude.

    Readers (submit fan-outs) may block inside the critical section on a
    ``block``-policy batcher — the writer just waits; space is freed by
    the batcher daemons, which never take this lock, so there is no
    deadlock, only a delayed swap (the router keeps serving the old view
    meanwhile). A waiting writer gates NEW readers out (writer priority):
    a sustained stream of overlapping submits must not starve the
    compaction rewire indefinitely.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        self._cond.acquire()
        self._writers_waiting += 1
        while self._readers:
            self._cond.wait()
        self._writers_waiting -= 1

    def release_write(self):
        self._cond.notify_all()
        self._cond.release()


class _Timer:
    """One shared lazy daemon firing scheduled callbacks (heap-ordered).

    Serves the router's two time-triggered paths: hedge triggers and the
    deadline reaper. ``on_stop`` decides an entry's fate when the timer
    is stopped with work still queued: ``"fire"`` runs it immediately
    (a deadline MUST expire its future — dropping it on shutdown would
    recreate the hang deadlines exist to kill), ``"drop"`` discards it
    (a hedge into a stopping router would enqueue work nobody flushes).
    Callbacks run on the timer thread and must be quick; exceptions are
    swallowed (one bad callback must not kill the reaper).
    """

    def __init__(self, name: str = "router-timer"):
        self._name = name
        self._cond = threading.Condition()
        self._heap: list = []
        self._seq = 0
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def schedule(self, when: float, fn, on_stop: str = "drop") -> None:
        with self._cond:
            heapq.heappush(self._heap, (when, self._seq, fn, on_stop))
            self._seq += 1
            self._stopped = False
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name=self._name, daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def _loop(self) -> None:
        while True:
            fn = None
            with self._cond:
                if self._stopped:
                    return
                if not self._heap:
                    self._cond.wait()
                else:
                    delay = self._heap[0][0] - time.monotonic()
                    if delay > 0:
                        self._cond.wait(delay)
                    else:
                        fn = heapq.heappop(self._heap)[2]
            if fn is not None:
                try:
                    fn()
                except Exception:  # noqa: BLE001 — reaper must survive
                    pass

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            leftovers = self._heap
            self._heap = []
            t = self._thread
            self._thread = None
            self._cond.notify_all()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        for _, _, fn, on_stop in sorted(leftovers):
            if on_stop == "fire":
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    pass


@dataclasses.dataclass(eq=False)
class _Replica:
    rid: int  # replica id within the shard (0..R-1)
    batcher: SearchRequestBatcher
    health: ReplicaHealth
    retired: bool = False  # flagged by swap_shards before the stop/drain

    def queue_depth(self) -> int:
        return self.batcher.queue_depth()


@dataclasses.dataclass(eq=False)
class _RouterShard:
    sid: int  # stable shard id (registration order)
    offset: int  # global file offset of the shard's range
    replicas: List[_Replica]


class _InFlight:
    """Per-request fan-out state: one slot per shard, first answer wins.

    ``parts[s]`` resolves exactly once per shard (("ok", result) or
    ("err", exc)); ``inflight``/``attempts``/``tried``/``hedged`` track
    the rescue machinery so an error is only final once no sibling
    attempt can still answer.
    """

    __slots__ = ("out", "query", "deadline", "tier", "entries", "lock",
                 "parts", "inflight", "attempts", "tried", "hedged", "stash",
                 "remaining")

    def __init__(self, out: Future, query: np.ndarray,
                 deadline: Optional[float], tier: Tier, entries: list):
        self.out = out
        self.query = query
        self.deadline = deadline
        self.tier = tier
        self.entries = entries
        self.lock = threading.Lock()
        n = len(entries)
        self.parts: List[Optional[tuple]] = [None] * n
        self.inflight = [0] * n
        self.attempts = [0] * n
        self.tried: List[List[int]] = [[] for _ in range(n)]
        self.hedged = [False] * n
        self.stash: List[Optional[BaseException]] = [None] * n
        self.remaining = n


class ShardedSearchRouter:
    """Fan queries out to replica shard groups; merge exact answers.

    Parameters
    ----------
    index:       a single assembled :class:`ParISIndex` (split into
                 ``num_shards`` file-order shards here), a prebuilt
                 :class:`ShardedIndex`, or None for an initially empty
                 router (shards attach later via :meth:`add_shard` — the
                 live-ingest bootstrap).
    num_shards:  shard count when ``index`` is a ParISIndex (ignored for a
                 prebuilt ShardedIndex).
    k:           None -> exact 1-NN (``SearchResult`` per request with
                 global file positions); int >= 1 -> exact k-NN
                 (((k,) dists ascending, (k,) global positions)).
    replicas:    R interchangeable replicas per shard (each its own
                 batcher + daemon; placement is p2c least-queue-depth
                 over the healthy ones). R=1 keeps the pre-replica
                 behavior.
    hedge_ms:    None disables hedging; a float re-issues an unanswered
                 sub-query on a sibling after that many ms; ``"auto"``
                 scales the trigger from the primary replica's EWMA
                 latency (``hedge_ewma_factor`` x EWMA, floored at
                 ``hedge_floor_ms``).
    hedge_budget / hedge_burst: hedges are capped at
                 ``hedge_budget * sub-queries + hedge_burst`` over the
                 router's life — the melt-protection bound.
    retry_failures: re-issue a sub-query once on a sibling after a typed
                 replica failure (never after a shed).
    down_after / probe_after_ms: per-replica health breaker knobs
                 (:class:`~repro_torch.serving.health.ReplicaHealth`).
    degrade:     a :class:`TierDegradePolicy` (or None to disable):
                 deadline-bearing requests with little remaining slack
                 are admitted at a cheaper tier (``exact -> epsilon ->
                 budget``) instead of being shed or expiring in queue.
                 Requires k-NN mode (tiers carry achieved bounds, which
                 the 1-NN ``SearchResult`` shape cannot).
    fault_injector: a :class:`~repro_torch.serving.faults.FaultInjector` whose
                 rules bite every replica's flush path (chaos testing).
    max_batch / max_wait_ms / min_bucket: per-replica batching knobs (see
                 :class:`SearchRequestBatcher`).
    max_pending / policy / block_timeout_ms: per-replica admission
                 control.
    cfg / round_size / select / impl / leaf_cap: engine knobs.

    Call ``start()`` to spawn one daemon flusher per replica (the serving
    mode); without it, ``poll()`` or ``drain()`` advance all replicas
    from the calling thread. Shards added later inherit the same knobs
    (and daemons, if started).
    """

    def __init__(
        self,
        index: Union[ParISIndex, ShardedIndex, None],
        num_shards: Optional[int] = None,
        *,
        k: Optional[int] = None,
        replicas: int = 1,
        hedge_ms: Union[float, str, None] = None,
        hedge_ewma_factor: float = 3.0,
        hedge_floor_ms: float = 1.0,
        hedge_budget: float = 0.1,
        hedge_burst: int = 4,
        retry_failures: bool = True,
        down_after: int = 3,
        probe_after_ms: float = 250.0,
        degrade: Optional[TierDegradePolicy] = None,
        fault_injector=None,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        cfg: SearchConfig = SearchConfig(),
        round_size: int = 4096,
        select: str = "topk",
        impl: str = "auto",
        leaf_cap: int = 256,
        min_bucket: int = 1,
        max_pending: Optional[int] = None,
        policy: str = "block",
        block_timeout_ms: Optional[float] = None,
    ):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if isinstance(hedge_ms, str) and hedge_ms != "auto":
            raise ValueError(
                f"hedge_ms must be None, a float, or 'auto', got "
                f"{hedge_ms!r}")
        if not 0.0 <= hedge_budget <= 1.0:
            raise ValueError("hedge_budget must be in [0, 1]")
        if degrade is not None and k is None:
            raise ValueError(
                "degrade needs k-NN mode (k >= 1): degraded tiers return "
                "(dists, positions, achieved_eps), which the 1-NN "
                "SearchResult mode cannot carry")
        self.k = k
        self.degrade = degrade
        self.replicas = replicas
        self.hedge_ms = hedge_ms
        self.hedge_ewma_factor = hedge_ewma_factor
        self.hedge_floor_ms = hedge_floor_ms
        self.hedge_budget = hedge_budget
        self.hedge_burst = hedge_burst
        self.retry_failures = retry_failures
        self.max_retries = 1
        self._injector = fault_injector
        self._health_knobs = dict(
            down_after=down_after, probe_after_ms=probe_after_ms)
        self._max_wait_ms = max_wait_ms
        # One knob-to-engine mapping for single-batcher and sharded
        # deployments alike: every shard (initial or dynamically added)
        # gets its engine from this same knob set (``_shard_engine``).
        self._knobs = dict(
            k=k, max_batch=max_batch, max_wait_ms=max_wait_ms, cfg=cfg,
            round_size=round_size, select=select, impl=impl,
            leaf_cap=leaf_cap, min_bucket=min_bucket,
            max_pending=max_pending, policy=policy,
            block_timeout_ms=block_timeout_ms,
        )
        self._entries: List[_RouterShard] = []
        self._next_sid = 0
        self._shards_rw = _RWLock()
        self._reg_lock = threading.Lock()  # serializes swaps/adds
        self._started = False
        self._timer = _Timer()
        self._stats_lock = threading.Lock()
        self._merge_stats = dict(merges=0, merge_ms_sum=0.0, merge_ms_max=0.0)
        self._fab = dict(
            shard_requests=0, retries=0, admission_retries=0, hedges=0,
            hedges_won=0, hedges_denied=0, deadline_expired=0,
            shard_failures=0, degraded=0,
        )
        self._retired_totals = dict(
            shards=0, submitted=0, answered=0, batches=0, padded_queries=0,
            rejected=0, shed=0, blocked=0, expired=0, blackholed=0,
            queue_depth_peak=0, latency_ms_max=0.0, batch_size_sum=0,
            tiered_answered=0, achieved_eps_sum=0.0, achieved_eps_max=0.0,
        )
        self.sharded: Optional[ShardedIndex] = None
        if index is None:
            return
        if isinstance(index, ShardedIndex):
            self.sharded = index
        else:
            if num_shards is None:
                raise ValueError(
                    "num_shards is required when passing a single index")
            self.sharded = build_sharded_index(index, num_shards)
        for shard, off in zip(self.sharded.shards, self.sharded.offsets):
            self._register(shard, off)

    def _shard_engine(self, shard):
        """The knob-matched batch engine of one shard, for all its replicas.

        Mirrors ``SearchRequestBatcher``'s own ``engine=None`` mapping
        (k=None reads the 1-NN knobs from ``cfg``). A
        :class:`~repro_torch.core.coldtier.ColdShard` gets the cold engine
        factory (the reference's ``_cold_engine``), so its replicas share
        one disk-backed engine and one block cache; an in-memory shard
        gets :func:`~repro_torch.core.search.make_batch_engine`.
        """
        factory = (make_cold_batch_engine if isinstance(shard, ColdShard)
                   else make_batch_engine)
        kb = self._knobs
        if kb["k"] is None:
            cfg = kb["cfg"]
            return factory(
                shard, k=None, round_size=cfg.round_size,
                leaf_cap=cfg.leaf_cap, sort=cfg.sort, select=cfg.select,
                impl=cfg.impl, min_bucket=kb["min_bucket"])
        return factory(
            shard, k=kb["k"], round_size=kb["round_size"],
            leaf_cap=kb["leaf_cap"], select=kb["select"],
            impl=kb["impl"], min_bucket=kb["min_bucket"])

    def _register(self, index, offset: int) -> int:
        """Create a shard's replica group (caller holds the write lock or
        __init__).

        ``index`` is a :class:`ParISIndex` or a cold-tier
        :class:`~repro_torch.core.coldtier.ColdShard`. The shard's
        replicas share one engine (``_shard_engine``); for a cold shard
        that is one disk-backed engine and therefore one block cache.

        The entry list is REPLACED, never mutated in place: lock-free
        readers (``poll``/``drain`` snapshot the reference) must always
        see a complete list, and an in-place ``list.sort`` exposes a
        transiently empty one.
        """
        sid = self._next_sid
        self._next_sid += 1
        engine = self._shard_engine(index)
        reps = []
        for rid in range(self.replicas):
            hook = None
            if self._injector is not None:
                hook = functools.partial(self._injector.on_flush, sid, rid)
            b = SearchRequestBatcher(
                index, inline_flush=False, fault_hook=hook, engine=engine,
                **self._knobs)
            reps.append(_Replica(
                rid, b, ReplicaHealth(**self._health_knobs)))
            if self._started:
                b.start()
        self._entries = sorted(
            self._entries + [_RouterShard(sid, int(offset), reps)],
            key=lambda e: e.offset)
        return sid

    @property
    def num_shards(self) -> int:
        """Number of live shards."""
        return len(self._entries)

    # --------------------------------------------------- dynamic shard set
    def add_shard(self, index: ParISIndex, offset: int) -> int:
        """Attach one shard owning file range [offset, offset+N) live.

        The shard gets a full replica group (admission-controlled
        batchers + the shard's shared engine) and, on a started router,
        daemon flushers. Returns the shard id for later retirement.
        Queries submitted after this call fan out over it.
        """
        return self.swap_shards((), [(index, offset)])[0]

    def swap_shards(
        self,
        retire: Sequence[int],
        add: Sequence[Tuple[ParISIndex, int]],
    ) -> List[int]:
        """Atomically retire shard ids and register replacement shards.

        The compaction rewire: the old base shards + folded delta shards
        detach and the compacted base attaches in ONE shard-set
        transition, so every query sees either the complete old partition
        or the complete new one — never a mix. Retired replicas are
        flagged first (late retries/hedges skip them), then stop and
        drain *after* detaching: anything they accepted before the swap
        is still answered, and their counters fold into the router totals
        (``stats()`` stays cumulative). Returns the new shard ids.
        """
        retire = set(retire)
        with self._reg_lock:
            self._shards_rw.acquire_write()
            try:
                unknown = retire - {e.sid for e in self._entries}
                if unknown:
                    raise ValueError(f"unknown shard ids: {sorted(unknown)}")
                old = [e for e in self._entries if e.sid in retire]
                for e in old:
                    for r in e.replicas:
                        r.retired = True
                self._entries = [
                    e for e in self._entries if e.sid not in retire]
                new_sids = [self._register(idx, off) for idx, off in add]
            finally:
                self._shards_rw.release_write()
            # Outside the write lock: joining a daemon mid-engine-call can
            # take a while, and new-view queries must not wait on it.
            for e in old:
                with self._stats_lock:
                    self._retired_totals["shards"] += 1
                for r in e.replicas:
                    r.batcher.stop(drain=True)
                    s = r.batcher.stats()
                    with self._stats_lock:
                        t = self._retired_totals
                        for key in ("submitted", "answered", "batches",
                                    "padded_queries", "rejected", "shed",
                                    "blocked", "expired", "blackholed",
                                    "batch_size_sum", "tiered_answered",
                                    "achieved_eps_sum"):
                            t[key] += s[key]
                        t["queue_depth_peak"] = max(
                            t["queue_depth_peak"], s["queue_depth_peak"])
                        t["latency_ms_max"] = max(
                            t["latency_ms_max"], s["latency_ms_max"])
                        t["achieved_eps_max"] = max(
                            t["achieved_eps_max"], s["achieved_eps_max"])
        return new_sids

    # ------------------------------------------------------------- request
    def submit(self, query, *,
               deadline_ms: Optional[float] = None,
               tier=None) -> Future:
        """Fan one (n,) query out; one Future for the global merge.

        ``deadline_ms`` is the request's END-TO-END budget: it rides into
        every replica queue (deadline-aware shedding / expiry) and arms
        the router's reaper — at the deadline an unanswered merged future
        fails with :class:`DeadlineExceededError`, whatever any replica
        is (or is not) doing.

        ``tier`` is the request's service tier (None / ``"exact"`` / a
        :class:`~repro_torch.core.search.Tier`): every shard answers at that
        tier and a non-exact request resolves to ``(dists, positions,
        achieved_eps)``, the achieved bound combined conservatively
        across shards. With a ``degrade`` policy, a deadline-bearing
        request short on slack is admitted at a cheaper tier (counted in
        ``stats()["degraded"]``). Non-exact tiers need k-NN mode.

        The fan-out snapshots the shard set (shared lock), so a
        concurrent ``swap_shards`` either misses this query entirely or
        sees it on every retired shard — both give a complete partition.
        One replica per shard is picked by health-gated p2c placement; a
        door-step :class:`QueueFullError` is retried once on a sibling
        and, if it stands, raised here naming the shard. Failures after
        acceptance resolve through the merged future (see the module
        docstring's failure taxonomy). On an empty router (no shards yet)
        the answer is the empty-datastore sentinel, resolved immediately.
        """
        q = host_rows(query)
        if q.ndim != 1:
            raise ValueError(f"submit takes one (n,) query, got {q.shape}")
        t = as_tier(tier)
        if t.kind != "exact" and self.k is None:
            raise ValueError(
                "service tiers need k-NN mode (k >= 1); the 1-NN "
                "SearchResult mode answers tier='exact' only")
        deadline = (None if deadline_ms is None
                    else time.monotonic() + deadline_ms / 1e3)
        out: Future = Future()
        if deadline is not None and deadline_ms <= 0:
            out.set_exception(DeadlineExceededError(
                f"deadline_ms={deadline_ms} already expired at submit"))
            return out
        if self.degrade is not None:
            picked = self.degrade.pick(t, deadline_ms)
            if picked is not t and picked.kind != t.kind:
                with self._stats_lock:
                    self._fab["degraded"] += 1
            t = picked
        self._shards_rw.acquire_read()
        try:
            entries = list(self._entries)
            if not entries:
                out.set_result(self._empty_result(t))
                return out
            req = _InFlight(out, q, deadline, t, entries)
            with self._stats_lock:
                self._fab["shard_requests"] += len(entries)
            primaries = []
            try:
                for s, e in enumerate(entries):
                    primaries.append(self._primary(req, s, e))
            except BaseException as exc:
                # A shard turned the request away mid-fan-out (after its
                # sibling retry): the request fails as a whole. Shards
                # that already accepted answer into resolved slots —
                # harmless (exact search is idempotent).
                out.set_exception(exc)
                raise
        finally:
            self._shards_rw.release_read()
        if deadline is not None:
            self._timer.schedule(
                deadline, functools.partial(self._expire, req, deadline_ms),
                on_stop="fire")
        if self.hedge_ms is not None and self.replicas > 1:
            now = time.monotonic()
            for s, (e, rep) in enumerate(zip(entries, primaries)):
                self._timer.schedule(
                    now + self._hedge_delay_s(rep),
                    functools.partial(self._maybe_hedge, req, s, e),
                    on_stop="drop")
        return out

    def _primary(self, req: _InFlight, s: int, entry: _RouterShard):
        """Launch the primary sub-query; sibling-retry a door-step
        reject once, then fail naming the shard (the partial-admission
        fix: one full replica queue no longer fails the merged query
        outright)."""
        try:
            rep = self._attempt(req, s, entry, kind="primary")
        except QueueFullError as cause:
            with self._stats_lock:
                self._fab["admission_retries"] += 1
            try:
                rep = self._attempt(req, s, entry, kind="retry")
            except QueueFullError as c2:
                cause = c2
                rep = None
            if rep is None:
                raise QueueFullError(
                    f"shard {entry.sid} (offset {entry.offset}) turned "
                    f"the request away after a sibling retry: {cause}"
                ) from cause
            with self._stats_lock:
                self._fab["retries"] += 1
            return rep
        if rep is None:
            raise ShardFailedError(
                entry.sid, f"shard {entry.sid} has no live replica")
        return rep

    def _attempt(self, req: _InFlight, s: int, entry: _RouterShard,
                 kind: str):
        """Submit the sub-query to one not-yet-tried replica.

        Returns the replica, or None when every replica was already
        tried (or retired). Raises the chosen replica's admission error
        (it still counts as tried, so a later retry lands elsewhere).
        """
        with req.lock:
            exclude = tuple(req.tried[s])
        live = [r for r in entry.replicas if not r.retired]
        rep = choose_replica(live, exclude=exclude)
        if rep is None:
            return None
        with req.lock:
            req.tried[s].append(rep.rid)
        fut = rep.batcher.submit(req.query, deadline=req.deadline,
                                 tier=req.tier)
        with req.lock:
            req.inflight[s] += 1
            req.attempts[s] += 1
        t0 = time.monotonic()
        fut.add_done_callback(functools.partial(
            self._on_answer, req, s, entry, rep, t0, kind))
        if rep.retired:
            # Raced a swap: the stop/drain may already have passed this
            # entry by and nobody will flush that batcher again — answer
            # it inline so the sub-query cannot strand.
            try:
                rep.batcher.drain()
            except Exception:  # noqa: BLE001 — the cohort carries it
                pass
        return rep

    def _hedge_delay_s(self, rep: _Replica) -> float:
        if self.hedge_ms == "auto":
            ewma = rep.health.ewma_ms
            base = ewma if ewma is not None else 4.0 * self._max_wait_ms
            ms = max(self.hedge_floor_ms, self.hedge_ewma_factor * base)
        else:
            ms = float(self.hedge_ms)
        return ms / 1e3

    def _maybe_hedge(self, req: _InFlight, s: int,
                     entry: _RouterShard) -> None:
        """Hedge trigger fired: re-issue the still-unanswered sub-query
        on a sibling, budget permitting (timer thread)."""
        if req.out.done():
            return
        with req.lock:
            if req.parts[s] is not None or req.hedged[s]:
                return
            req.hedged[s] = True
        with self._stats_lock:
            f = self._fab
            allowed = f["hedges"] < (
                self.hedge_budget * f["shard_requests"] + self.hedge_burst)
            if not allowed:
                f["hedges_denied"] += 1
        if not allowed:
            return
        try:
            rep = self._attempt(req, s, entry, kind="hedge")
        except QueueFullError:
            rep = None  # the sibling is saturated; the primary stands
        if rep is not None:
            with self._stats_lock:
                self._fab["hedges"] += 1

    def _expire(self, req: _InFlight, deadline_ms: float) -> None:
        """Deadline reaper: an unanswered merged future fails NOW."""
        if req.out.done():
            return
        if self._try_set_exception(req.out, DeadlineExceededError(
                f"deadline_ms={deadline_ms} exceeded before "
                f"{req.remaining} of {len(req.entries)} shard(s) "
                "answered")):
            with self._stats_lock:
                self._fab["deadline_expired"] += 1

    @staticmethod
    def _try_set_result(fut: Future, result) -> bool:
        try:
            fut.set_result(result)
            return True
        except InvalidStateError:
            return False  # the deadline reaper got there first

    @staticmethod
    def _try_set_exception(fut: Future, exc: BaseException) -> bool:
        try:
            fut.set_exception(exc)
            return True
        except InvalidStateError:
            return False

    # ------------------------------------------------- sub-query lifecycle
    def _on_answer(self, req: _InFlight, s: int, entry: _RouterShard,
                   rep: _Replica, t0: float, kind: str, fut: Future) -> None:
        lat_ms = (time.monotonic() - t0) * 1e3
        exc = fut.exception()
        if exc is None:
            rep.health.record_success(lat_ms)
            res = fut.result()
            with req.lock:
                req.inflight[s] -= 1
                if req.parts[s] is not None:
                    return  # a sibling answered first
                req.parts[s] = ("ok", res)
                req.remaining -= 1
                last = req.remaining == 0
            if kind == "hedge":
                with self._stats_lock:
                    self._fab["hedges_won"] += 1
            if last:
                self._finish(req)
            return
        # Failure. Sheds and deadline expiries are not the replica's
        # fault (and retrying a shed re-amplifies the load being shed);
        # anything else trips the replica's breaker and may be retried.
        benign = isinstance(exc, (RequestShedError, DeadlineExceededError))
        if not benign:
            rep.health.record_failure()
        self._shard_failure(req, s, entry, exc,
                            retriable=self.retry_failures and not benign)

    def _shard_failure(self, req: _InFlight, s: int, entry: _RouterShard,
                       exc: BaseException, retriable: bool) -> None:
        with req.lock:
            req.inflight[s] -= 1
            if req.parts[s] is not None or req.out.done():
                return
            if req.stash[s] is None:
                req.stash[s] = exc
            past = (req.deadline is not None
                    and time.monotonic() >= req.deadline)
            can_retry = (retriable and not past
                         and req.attempts[s] <= self.max_retries)
        if can_retry:
            try:
                rep = self._attempt(req, s, entry, kind="retry")
            except QueueFullError as e2:
                rep = None
                with req.lock:
                    req.stash[s] = req.stash[s] or e2
            if rep is not None:
                with self._stats_lock:
                    self._fab["retries"] += 1
                return
        with req.lock:
            if req.parts[s] is not None or req.inflight[s] > 0:
                return  # a sibling attempt may still answer
            cause = req.stash[s]
            err = self._shard_error(entry, cause, req.attempts[s])
            req.parts[s] = ("err", err)
            req.remaining -= 1
            last = req.remaining == 0
        with self._stats_lock:
            self._fab["shard_failures"] += 1
        if last:
            self._finish(req)

    @staticmethod
    def _shard_error(entry: _RouterShard, cause: BaseException,
                     attempts: int) -> BaseException:
        """The typed error a lost shard contributes to the merge.

        Admission and deadline errors pass through (they are already
        typed and actionable); everything else wraps in a
        :class:`ShardFailedError` naming the shard, with the replica
        error as ``__cause__``.
        """
        if isinstance(cause, (QueueFullError, DeadlineExceededError)):
            return cause
        err = ShardFailedError(
            entry.sid,
            f"shard {entry.sid} (offset {entry.offset}) failed after "
            f"{attempts} attempt(s): {cause!r}")
        err.__cause__ = cause
        return err

    def _empty_result(self, tier: Optional[Tier] = None):
        if self.k is None:
            z = np.int32(0)
            return SearchResult(
                np.float32(np.inf), np.int32(_NO_POS), z, z, z)
        empty = (np.full((self.k,), np.float32(np.inf)),
                 np.full((self.k,), _NO_POS, np.int32))
        if tier is not None and tier.kind != "exact":
            return (*empty, 0.0)  # nothing to miss in an empty datastore
        return empty

    def _finish(self, req: _InFlight) -> None:
        out, parts, entries = req.out, req.parts, req.entries
        err = next((e for tag, e in parts if tag == "err"), None)
        if err is not None:
            self._try_set_exception(out, err)
            return
        try:
            t0 = time.perf_counter()
            results = [r for _, r in parts]
            if self.k is None:
                merged = self._merge_1nn(results, entries)
            else:
                merged = self._merge_knn(results, entries, req.tier)
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._stats_lock:
                m = self._merge_stats
                m["merges"] += 1
                m["merge_ms_sum"] += dt_ms
                m["merge_ms_max"] = max(m["merge_ms_max"], dt_ms)
            self._try_set_result(out, merged)
        except BaseException as e:  # noqa: BLE001 — surface merge bugs
            self._try_set_exception(out, e)

    @staticmethod
    def _global_pos(pos, entry: _RouterShard):
        """Shard-local positions -> file positions (NO_POS passes through)."""
        pos = np.asarray(pos)
        return np.where(pos >= 0, pos + entry.offset, _NO_POS).astype(
            pos.dtype)

    def _merge_knn(self, results: list, entries: list,
                   tier: Tier) -> tuple:
        # Ownership-disjoint (k,) lists -> global k smallest, via the
        # shared merge protocol (entries are offset-ascending, so ties —
        # and only ties — resolve toward the lower file range; sentinel
        # INF slots sink).
        d, p = merge_top_lists(
            [r[0] for r in results],
            [self._global_pos(r[1], e) for e, r in zip(entries, results)],
            self.k,
        )
        if tier.kind == "exact":
            return d, p
        # Conservative cross-shard combine: the merged k-th distance is
        # <= every shard's k-th, so each shard's (1+eps_s) certificate
        # holds a fortiori for the merged list — the worst shard bounds
        # the whole answer.
        return d, p, max(float(r[2]) for r in results)

    def _merge_1nn(self, results: list, entries: list) -> SearchResult:
        dists = [float(r.dist_sq) for r in results]
        best = min(
            range(len(results)),
            key=lambda s: (dists[s], int(self._global_pos(
                results[s].position, entries[s]))),
        )
        r = results[best]
        return SearchResult(
            np.asarray(r.dist_sq),
            self._global_pos(r.position, entries[best]),
            np.sum([np.asarray(x.raw_reads) for x in results]),
            np.sum([np.asarray(x.bsf_updates) for x in results]),
            np.max([np.asarray(x.rounds) for x in results]),
        )

    # ----------------------------------------------------------- batch API
    def search_batch(self, queries, *, tier=None):
        """Synchronous convenience: (Q, n) -> merged results via the stream.

        Submits every row, drains, and stacks: ``k=None`` gives a
        ``SearchResult`` of (Q,) arrays; ``k >= 1`` gives ((Q, k) dists,
        (Q, k) global positions) — plus a (Q,) achieved-epsilon array
        when ``tier`` is non-exact (one tier for the whole batch).
        Admission control still applies — with a bound tighter than Q,
        ``shed``/``reject`` can fail rows. Without the daemon flushers,
        full cohorts are flushed between submits (``poll``) so a
        ``block`` bound tighter than Q makes progress instead of
        deadlocking the submitting thread.
        """
        qs = host_rows(queries)
        t = as_tier(tier)
        futs = []
        for q in qs:
            if not self._started:
                # No daemon to free queue space: flush whatever is due so
                # a blocking submit always finds room (max_pending >=
                # max_batch is enforced, so a full queue has a full batch).
                self.poll()
            futs.append(self.submit(q, tier=t))
        self.drain()
        res = [f.result() for f in futs]
        if self.k is None:
            return SearchResult(
                np.stack([np.asarray(r.dist_sq) for r in res]),
                np.stack([np.asarray(r.position) for r in res]),
                np.stack([np.asarray(r.raw_reads) for r in res]),
                np.stack([np.asarray(r.bsf_updates) for r in res]),
                np.max([np.asarray(r.rounds) for r in res]),
            )
        d = np.stack([r[0] for r in res])
        p = np.stack([r[1] for r in res])
        if t.kind != "exact":
            return d, p, np.asarray([r[2] for r in res], np.float32)
        return d, p

    # ----------------------------------------------------------- lifecycle
    def start(self, tick_ms: Optional[float] = None) -> None:
        """Spawn one daemon flusher per replica (concurrent search)."""
        self._shards_rw.acquire_read()
        try:
            self._started = True
            for e in self._entries:
                for r in e.replicas:
                    r.batcher.start(tick_ms)
        finally:
            self._shards_rw.release_read()

    def stop(self, drain: bool = True) -> None:
        """Stop all replica flushers; by default answer what is left.

        The timer stops last: pending deadline entries fire (their
        futures must resolve), pending hedge triggers are dropped.
        """
        self._shards_rw.acquire_read()
        try:
            self._started = False
            entries = list(self._entries)
        finally:
            self._shards_rw.release_read()
        for e in entries:
            for r in e.replicas:
                r.batcher.stop(drain=drain)
        self._timer.stop()

    def poll(self) -> int:
        """Advance every replica's due flushes from the calling thread."""
        return sum(r.batcher.poll()
                   for e in list(self._entries) for r in e.replicas)

    def drain(self) -> int:
        """Flush every replica to empty; returns the answered total."""
        return sum(r.batcher.drain()
                   for e in list(self._entries) for r in e.replicas)

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Aggregate per-replica batcher counters + fabric health.

        Counts are per *replica request* (each submitted query lands on
        one replica per shard, plus retries/hedges);
        ``submitted``/``answered``/``rejected``/``shed`` therefore sum
        over every replica — including replicas already retired by
        :meth:`swap_shards`, so totals are cumulative across the
        router's life. ``queue_depth_peak`` is the max over replicas;
        latency figures are worst-replica. ``queue_depths`` is the
        instantaneous per-live-shard pending depth (summed over the
        shard's replicas), ``health`` the per-replica breaker/EWMA
        snapshots, and the hedging/retry/deadline counters the fabric's
        rescue activity — together they let a caller spot saturation,
        a dead replica, or a melting hedge budget without poking
        internals.
        """
        self._shards_rw.acquire_read()
        try:
            live = [
                (e.sid, e.offset,
                 [(r.rid, r.health.snapshot(), r.batcher.stats())
                  for r in e.replicas])
                for e in self._entries
            ]
        finally:
            self._shards_rw.release_read()
        per = [st for _, _, reps in live for _, _, st in reps]
        with self._stats_lock:
            ret = dict(self._retired_totals)
            merge = dict(self._merge_stats)
            fab = dict(self._fab)
        agg = dict(
            num_shards=len(live),
            replicas=self.replicas,
            retired_shards=ret["shards"],
            submitted=sum(s["submitted"] for s in per) + ret["submitted"],
            answered=sum(s["answered"] for s in per) + ret["answered"],
            batches=sum(s["batches"] for s in per) + ret["batches"],
            padded_queries=(sum(s["padded_queries"] for s in per)
                            + ret["padded_queries"]),
            rejected=sum(s["rejected"] for s in per) + ret["rejected"],
            shed=sum(s["shed"] for s in per) + ret["shed"],
            blocked=sum(s["blocked"] for s in per) + ret["blocked"],
            expired=sum(s["expired"] for s in per) + ret["expired"],
            blackholed=(sum(s["blackholed"] for s in per)
                        + ret["blackholed"]),
            queued=sum(s["queued"] for s in per),
            queue_depths=[sum(st["queued"] for _, _, st in reps)
                          for _, _, reps in live],
            queue_depth_peak=max(
                [s["queue_depth_peak"] for s in per]
                + [ret["queue_depth_peak"]], default=0),
            latency_ms_avg=max(
                (s["latency_ms_avg"] for s in per), default=0.0),
            latency_ms_max=max(
                [s["latency_ms_max"] for s in per]
                + [ret["latency_ms_max"]], default=0.0),
            batch_size_avg=(
                (sum(s["batch_size_sum"] for s in per)
                 + ret["batch_size_sum"])
                / max(sum(s["batches"] for s in per) + ret["batches"], 1)),
            qps=min((s["qps"] for s in per), default=0.0),
            tiered_answered=(sum(s["tiered_answered"] for s in per)
                             + ret["tiered_answered"]),
            achieved_eps_max=max(
                [s["achieved_eps_max"] for s in per]
                + [ret["achieved_eps_max"]], default=0.0),
            achieved_eps_avg=(
                (sum(s["achieved_eps_sum"] for s in per)
                 + ret["achieved_eps_sum"])
                / max(sum(s["tiered_answered"] for s in per)
                      + ret["tiered_answered"], 1)),
            merges=merge["merges"],
            merge_ms_avg=merge["merge_ms_sum"] / max(merge["merges"], 1),
            merge_ms_max=merge["merge_ms_max"],
            per_shard=per,
            shard_ids=[sid for sid, _, _ in live],
            shard_offsets=[off for _, off, _ in live],
            health=[dict(sid=sid, offset=off,
                         replicas=[dict(rid=rid, **h)
                                   for rid, h, _ in reps])
                    for sid, off, reps in live],
            **fab,
        )
        return agg

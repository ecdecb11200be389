"""Streaming search service: an adaptive query batcher over the batch engine.

The ParIS+ batch engine answers a (Q, n) query matrix in one fused
lower-bound pass + one shared RDC loop — but a serving workload is a
*stream* of single queries, not a fixed-B matrix. ``SearchRequestBatcher``
is the host-side adapter between the two:

  * ``submit(query)`` enqueues one query (a host ``float32`` row) and
    returns a ``concurrent.futures.Future`` for its answer;
  * a flush fires when ``max_batch`` queries are waiting (full batch) or
    the oldest request has waited ``max_wait_ms`` (latency bound), echoing
    the paper's goal that workers are handed enough work to all finish
    "at about the same time" without starving latency;
  * flushed queries are stacked on the host and ride a
    :func:`repro_torch.core.search.make_batch_engine` engine, which uploads
    the cohort to the index's device once and pads it to a power-of-two
    batch shape (pad rows repeat a real query and are discarded). The
    answers come back to the host in ONE copy per cohort — each of the
    engine's result tensors moves with one ``.cpu()`` — and are split into
    numpy rows per request, so a future resolves to numpy arrays exactly
    as the JAX package's do, and nothing on the answer path copies or
    reads a single query's value from the device;
  * the pending queue is *bounded* (``max_pending`` + ``policy``):
    admission control keeps a traffic burst from growing the queue — and
    the tail latency of everything behind it — without bound. ``block``
    makes ``submit`` wait for space (the cooperative backpressure mode),
    ``reject`` raises :class:`QueueFullError` at the door, and
    ``shed-oldest`` evicts a queued request (failing its future with
    :class:`RequestShedError`) in favor of the new arrival. Queue-depth
    peaks and shed/reject counts ride next to the qps/latency counters;
  * requests may carry an absolute *deadline* (``submit(q, deadline=t)``,
    monotonic seconds): shedding is then deadline-aware — the victim is
    the request with the least time-to-deadline (deadline-less requests
    rank as infinitely patient and fall back to oldest-first) — and a
    flush fails requests whose deadline passed with
    :class:`DeadlineExceededError` instead of spending engine time on an
    answer nobody is waiting for;
  * a *fault hook* (``fault_hook=``, see ``serving.faults``) instruments
    the flush path for chaos testing: it may sleep (injected latency),
    raise (the cohort's futures carry the typed error), or return False
    (blackhole: the cohort is consumed and never answered — the
    accepted-then-lost failure mode hedging and deadlines exist for);
  * ``drain()`` answers everything still queued (shutdown / test barrier);
  * throughput and latency counters ride along (``stats()``).

Two modes: ``k=None`` answers exact 1-NN (per-request ``SearchResult`` of
numpy scalars); ``k >= 1`` answers exact k-NN (per-request ((k,) dists,
(k,) positions)).

Service tiers (k-NN mode): ``submit(q, tier=Tier.epsilon(0.05))`` asks
for an approximate answer with a guarantee (see
:class:`repro_torch.core.search.Tier`); a cohort holding any non-exact
request rides the engine's tiered call with per-row tier parameters —
exact and approximate requests batch together — and a non-exact
request's future resolves to ``((k,) dists, (k,) positions,
achieved_epsilon)`` (exact requests keep the 2-tuple shape).

This is the JAX package's ``repro.serving.search_batcher`` over the
port's engines, with the same names, counters and ``stats()`` keys.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.index import ParISIndex
from repro_torch.core.search import (
    SearchConfig, SearchResult, Tier, as_tier, make_batch_engine,
)

ADMISSION_POLICIES = ("block", "reject", "shed-oldest")


class QueueFullError(RuntimeError):
    """Admission control turned a request away (queue at ``max_pending``).

    Raised from ``submit`` under the ``reject`` policy (and by ``block``
    on timeout); the :class:`RequestShedError` subclass is set as the
    *future's* exception for requests evicted by ``shed-oldest`` — either
    way the caller sees a typed backpressure signal instead of an
    unbounded queue.
    """


class RequestShedError(QueueFullError):
    """A queued request was evicted by admission control (shed policy).

    A subclass so ``QueueFullError`` handlers still match, but
    distinguishable: an eviction is the queue actively choosing to drop
    THIS request under overload — the router must not retry it on a
    sibling (that would re-amplify the very load being shed), unlike a
    door-step reject, which may simply have raced a draining queue.
    """


class DeadlineExceededError(RuntimeError):
    """The request's end-to-end deadline passed before it was answered.

    Set on futures by the deadline-aware flush path here and by the
    router's deadline reaper — a request under a deadline resolves with
    an answer or with this, never with a hang.
    """


def host_rows(x) -> np.ndarray:
    """Queries as a host ``float32`` array (a tensor is copied once)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _host(x) -> np.ndarray:
    """An engine output (a tensor on any device, or numpy) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class _Pending:
    query: np.ndarray  # (n,) float32, host
    future: Future
    t_submit: float
    deadline: Optional[float] = None  # absolute monotonic seconds
    tier: Tier = Tier.exact()  # requested service tier (k-NN mode)


class SearchRequestBatcher:
    """Queue single queries; answer them in padded power-of-two batches.

    Parameters
    ----------
    index:        the ParISIndex to search (its device runs the engine).
    k:            None -> exact 1-NN (``SearchResult`` per request);
                  int >= 1 -> exact k-NN (((k,) dists, (k,) pos) per
                  request).
    max_batch:    flush as soon as this many queries are waiting.
    max_wait_ms:  flush (on ``poll``/background thread) once the oldest
                  request has waited this long, even if the batch is small.
    cfg:          SearchConfig for 1-NN mode (round_size/select/impl).
    round_size / select / impl / leaf_cap: k-NN engine knobs.
    min_bucket:   smallest padded batch shape.
    max_pending:  bound on the pending queue (None = unbounded). With a
                  bound, ``policy`` decides what saturation does:
                  ``block`` (submit waits for space; pair with the daemon
                  flusher or a concurrent poller, else a full queue can
                  only clear via another thread's ``drain``), ``reject``
                  (submit raises :class:`QueueFullError`), ``shed-oldest``
                  (the stalest queued request's future fails with
                  :class:`QueueFullError` and the new arrival is queued).
    block_timeout_ms: ``block`` only — give up (QueueFullError) after
                  waiting this long for space (None = wait forever).
    inline_flush: flush full batches inside ``submit`` (default). False
                  defers every flush to ``poll``/daemon/``drain`` — the
                  router mode, where each replica's daemon thread does its
                  own engine calls so S shards flush in parallel.
    engine:       a prebuilt :func:`repro_torch.core.search.
                  make_batch_engine` callable (the router passes one
                  engine per shard, shared by its replicas); built from
                  the knobs above when omitted.
    fault_hook:   chaos instrumentation (``serving.faults``): called at
                  the top of every flush; may sleep, raise, or return
                  False to blackhole the cohort. None (default) costs
                  nothing.

    Thread-safe: ``submit`` may be called from any thread. Each flush
    claims its cohort of pending requests atomically under the lock, so
    every request is answered exactly once; the engine call itself runs
    OUTSIDE the lock, so flushes of several batchers (or of one batcher
    from several threads) may overlap. The engine keeps no state between
    calls, and every launch goes to the current stream of the calling
    thread (the device's default stream). ``start()`` spawns a daemon
    thread that enforces ``max_wait_ms`` (and, with
    ``inline_flush=False``, full-batch flushes) for callers that block on
    futures; without it, call ``poll()`` periodically or ``drain()`` at a
    barrier.
    """

    def __init__(
        self,
        index: ParISIndex,
        *,
        k: Optional[int] = None,
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
        inline_flush: bool = True,
        engine=None,
        fault_hook=None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if k is not None and k < 1:
            raise ValueError("k must be None (1-NN mode) or >= 1")
        if policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"policy must be one of {ADMISSION_POLICIES}, got {policy!r}")
        if max_pending is not None and max_pending < max_batch:
            raise ValueError(
                f"max_pending={max_pending} < max_batch={max_batch} could "
                "never fill a batch")
        self.index = index
        self.k = k
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_pending = max_pending
        self.policy = policy
        self.block_timeout_ms = block_timeout_ms
        self.inline_flush = inline_flush
        if engine is None:
            if k is None:
                engine = make_batch_engine(
                    index, k=None, round_size=cfg.round_size,
                    leaf_cap=cfg.leaf_cap, sort=cfg.sort, select=cfg.select,
                    impl=cfg.impl, min_bucket=min_bucket,
                )
            else:
                engine = make_batch_engine(
                    index, k=k, round_size=round_size, leaf_cap=leaf_cap,
                    select=select, impl=impl, min_bucket=min_bucket,
                )
        self._engine = engine
        self._fault_hook = fault_hook
        self._pending: List[_Pending] = []
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._t0 = time.monotonic()
        self._counters = dict(
            submitted=0, answered=0, batches=0, padded_queries=0,
            flush_full=0, flush_timeout=0, flush_drain=0,
            rejected=0, shed=0, blocked=0, queue_depth_peak=0,
            expired=0, blackholed=0,
            tiered_answered=0, achieved_eps_sum=0.0, achieved_eps_max=0.0,
            latency_ms_sum=0.0, latency_ms_max=0.0, batch_size_sum=0,
        )

    def queue_depth(self) -> int:
        """Instantaneous pending-queue depth (the placement signal)."""
        with self._lock:
            return len(self._pending)

    # ------------------------------------------------------------- request
    def submit(self, query, deadline: Optional[float] = None,
               tier=None) -> Future:
        """Enqueue one (n,) query; returns a Future for its result.

        The query waits as a host ``float32`` row (a tensor argument is
        copied to the host here). ``deadline`` is an absolute
        ``time.monotonic()`` instant: once it passes, the request is failed
        with :class:`DeadlineExceededError` at the next flush instead of
        being answered (the router threads per-request ``deadline_ms``
        through here).

        ``tier`` selects the request's service tier (None / "exact" / a
        :class:`~repro_torch.core.search.Tier`); non-exact tiers need k-NN
        mode and resolve the future to ((k,) dists, (k,) pos,
        achieved_eps). Tier parameters are validated here, at the door.

        Admission control applies first (see ``max_pending``/``policy``):
        ``reject`` raises :class:`QueueFullError` at saturation, ``block``
        waits for space, ``shed-oldest`` evicts the queued request with
        the least time-to-deadline (oldest-first among deadline-less
        requests; its future fails with :class:`RequestShedError`).
        """
        q = host_rows(query)
        if q.ndim != 1:
            raise ValueError(f"submit takes one (n,) query, got {q.shape}")
        t = as_tier(tier)
        if t.kind != "exact" and self.k is None:
            raise ValueError(
                "service tiers need k-NN mode (k >= 1); the 1-NN "
                "SearchResult mode answers tier='exact' only")
        fut: Future = Future()
        shed_futs: List[Future] = []
        with self._lock:
            c = self._counters
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                if self.policy == "reject":
                    c["rejected"] += 1
                    raise QueueFullError(
                        f"pending queue full ({self.max_pending}); "
                        "request rejected")
                elif self.policy == "shed-oldest":
                    while len(self._pending) >= self.max_pending:
                        old = self._pending.pop(self._shed_victim())
                        c["shed"] += 1
                        shed_futs.append(old.future)
                else:  # block
                    c["blocked"] += 1
                    give_up = (
                        None if self.block_timeout_ms is None
                        else time.monotonic() + self.block_timeout_ms / 1e3)
                    while len(self._pending) >= self.max_pending:
                        left = (None if give_up is None
                                else give_up - time.monotonic())
                        expired = left is not None and left <= 0
                        if expired or not self._space.wait(timeout=left):
                            # A timed-out block turned the request away,
                            # same as a reject — count it as one.
                            c["rejected"] += 1
                            raise QueueFullError(
                                "timed out waiting for queue space "
                                f"({self.max_pending} pending)")
            self._pending.append(
                _Pending(q, fut, time.monotonic(), deadline, t))
            c["submitted"] += 1
            c["queue_depth_peak"] = max(
                c["queue_depth_peak"], len(self._pending))
            full = len(self._pending) >= self.max_batch
        for sf in shed_futs:  # outside the lock: callbacks may run inline
            sf.set_exception(RequestShedError(
                "request shed from a full queue by a newer arrival"))
        if full and self.inline_flush:
            self._flush("flush_full")
        return fut

    def _shed_victim(self) -> int:
        """Index of the pending request to evict (caller holds the lock).

        Least time-to-deadline first — an expired or nearly-expired
        request is dead weight; dropping it costs the least useful work.
        Requests without a deadline have infinite patience and lose only
        to each other, oldest first.
        """
        now = time.monotonic()

        def key(p: _Pending):
            slack = float("inf") if p.deadline is None else p.deadline - now
            return (slack, p.t_submit)

        return min(range(len(self._pending)),
                   key=lambda i: key(self._pending[i]))

    def poll(self) -> int:
        """Flush what is due: full batches (``inline_flush=False`` mode)
        and timed-out partial batches (``max_wait_ms``).

        Returns the number of requests answered by this call.
        """
        total = 0
        while True:
            with self._lock:
                if not self._pending:
                    return total
                full = len(self._pending) >= self.max_batch
                now = time.monotonic()
                age_ms = (now - self._pending[0].t_submit) * 1e3
                head = self._pending[0]
                due = age_ms >= self.max_wait_ms or (
                    head.deadline is not None and head.deadline <= now)
            if full and not self.inline_flush:
                total += self._flush("flush_full")
            elif due:
                total += self._flush("flush_timeout")
            else:
                return total

    def drain(self) -> int:
        """Answer every queued request; returns how many were answered."""
        total = 0
        while True:
            n = self._flush("flush_drain")
            if n == 0:
                return total
            total += n

    # ----------------------------------------------------------- lifecycle
    def start(self, tick_ms: Optional[float] = None) -> None:
        """Spawn the daemon flusher enforcing ``max_wait_ms``."""
        if self._thread is not None:
            return
        tick = (tick_ms if tick_ms is not None else
                max(self.max_wait_ms / 4.0, 0.25)) / 1e3

        def loop():
            while not self._stop.wait(tick):
                try:
                    self.poll()
                except Exception:  # noqa: BLE001 — the cohort carries it
                    # The failing cohort's futures already carry the
                    # exception; the flusher must outlive one bad batch or
                    # every later small batch would hang un-flushed.
                    pass

        self._stop.clear()
        self._thread = threading.Thread(
            target=loop, name="search-batcher", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the flusher thread; by default answer what is left."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        if drain:
            self.drain()

    # ------------------------------------------------------------- engine
    def _flush(self, reason: str) -> int:
        with self._lock:
            if not self._pending:
                return 0
            take = self._pending[: self.max_batch]
            del self._pending[: self.max_batch]
            self._space.notify_all()  # blocked submitters may now enqueue
        # Deadline shedding: a request whose deadline already passed gets
        # its typed error now — engine time goes only to answers someone
        # is still waiting for. (The cohort was claimed above, so expired
        # requests still count toward this flush's progress.)
        now = time.monotonic()
        live: List[_Pending] = []
        expired: List[_Pending] = []
        for p in take:
            dead = p.deadline is not None and p.deadline <= now
            (expired if dead else live).append(p)
        if expired:
            take = live
            with self._lock:
                self._counters["expired"] += len(expired)
            for p in expired:
                p.future.set_exception(DeadlineExceededError(
                    "deadline passed while the request was queued"))
            if not take:
                return len(expired)
        try:
            qn = len(take)
            if self._fault_hook is not None:
                # Chaos instrumentation: may sleep (latency), raise (the
                # cohort fails typed, below), or blackhole the cohort —
                # consumed, never answered, exactly what a partitioned-
                # off replica does to accepted requests.
                if self._fault_hook() is False:
                    with self._lock:
                        self._counters["blackholed"] += qn
                    return qn + len(expired)
            bucket = self._engine.bucket(qn)
            qs = np.stack([p.query for p in take])
            tiers = [p.tier for p in take]
            ach = None
            if any(t.kind != "exact" for t in tiers):
                # Mixed-tier cohort: ONE tiered engine call answers every
                # row at its own tier. Exact requests keep their 2-tuple
                # result shape; tiered requests get achieved_eps appended.
                d, pos, ach = self._engine(qs, tiers=tiers)
                d, pos, ach = _host(d), _host(pos), _host(ach)
                outs = [
                    (d[i], pos[i], float(ach[i]))
                    if tiers[i].kind != "exact" else (d[i], pos[i])
                    for i in range(qn)
                ]
            elif self.k is None:
                outs = _split_search(self._engine(qs), qn)
            else:
                d, pos = self._engine(qs)
                d, pos = _host(d), _host(pos)
                outs = [(d[i], pos[i]) for i in range(qn)]
        except BaseException as e:  # noqa: BLE001 — propagate per request
            for p in take:
                p.future.set_exception(e)
            raise
        now = time.monotonic()
        c = self._counters
        with self._lock:
            c[reason] += 1
            c["batches"] += 1
            c["batch_size_sum"] += qn
            c["padded_queries"] += bucket - qn
            c["answered"] += qn
            if ach is not None:
                for i, t in enumerate(tiers):
                    if t.kind != "exact":
                        c["tiered_answered"] += 1
                        c["achieved_eps_sum"] += float(ach[i])
                        c["achieved_eps_max"] = max(
                            c["achieved_eps_max"], float(ach[i]))
            for p in take:
                lat = (now - p.t_submit) * 1e3
                c["latency_ms_sum"] += lat
                c["latency_ms_max"] = max(c["latency_ms_max"], lat)
        for p, out in zip(take, outs):
            p.future.set_result(out)
        return qn + len(expired)

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Counters + derived throughput/latency figures (a shallow copy)."""
        with self._lock:
            c = dict(self._counters)
            c["queued"] = len(self._pending)
        n = max(c["answered"], 1)
        b = max(c["batches"], 1)
        c["latency_ms_avg"] = c["latency_ms_sum"] / n
        c["batch_size_avg"] = c["batch_size_sum"] / b
        c["achieved_eps_avg"] = (
            c["achieved_eps_sum"] / max(c["tiered_answered"], 1))
        c["qps"] = c["answered"] / max(time.monotonic() - self._t0, 1e-9)
        return c


def _split_search(res: SearchResult, qn: int) -> list:
    """(Q,)-vector SearchResult -> per-request SearchResults of numpy
    scalars (one host copy per field for the whole cohort)."""
    d = _host(res.dist_sq)
    p = _host(res.position)
    reads = _host(res.raw_reads)
    upd = _host(res.bsf_updates)
    rounds = _host(res.rounds)
    return [
        SearchResult(d[i], p[i], reads[i], upd[i], rounds)
        for i in range(qn)
    ]

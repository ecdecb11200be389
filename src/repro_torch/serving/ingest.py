"""Ingest-while-serving: a mutable index wired into the sharded router.

``core.ingest`` gives exact search over a growing datastore;
``serving.router`` gives streamed, admission-controlled, multi-threaded
query answering over a dynamic shard set. :class:`IngestingRouter` is the
production composition of the two — the ParIS+ story ("index construction
overlaps completely with I/O") carried into serving: series are inserted
while queries are in flight, every answer stays exact, and compaction
never blocks either side.

Data path::

    append(batch)  ----->  IngestPipeline -> DeltaShard      (Stage-2:
        |                       |                             paa_isax ->
        |                       v                             refine keys ->
        |                  MutableIndex snapshot swap         presort; spill
        |                       |                             + manifest
        |                       |                             commit when
        |                       |                             durable)
        +--- router.add_shard(delta.index, delta.base) ------ the delta is
                                                              immediately a
                                                              first-class
                                                              routed shard
    compaction daemon (background thread):
        policy.plan(snapshot)?  -> mutable.compact(tier=...)
            minor: merge_runs(delta tier)    (linear merges, no locks held;
                -> ONE run shard              queries/appends keep flowing;
            major: merge_runs(base + runs)    merge cost bounded by the
                -> new base                   folded tier, never O(total))
            publish snapshot                 (microsecond swap)
        -> reconcile router vs snapshot      (diff the attached components
            minor: folded delta shards out,   against the published
                   the run shard in           snapshot; apply the whole
            major: old base + run shards out, diff as ONE atomic
                   resharded base in)         swap_shards transition)

Consistency: the router's shard set always covers exactly the series of
some recent snapshot — appends register their delta *after* the mutable
publish (a query racing the append sees the pre-append view; the append
is not complete until registration returns), and the compaction rewire is
a *reconciliation*: it diffs the live snapshot's components against the
attached shard ids and applies the difference in one atomic swap. That
makes the rewire idempotent and self-healing — if the daemon dies between
a finished fold and the swap (chaos-tested via the ``"swap"`` fault
point), the old components keep serving the same file ranges (still
exact) and the NEXT tick's reconcile completes the rewire; nothing is
double-attached and no range is ever uncovered. Exactness therefore
holds at every instant, including mid-compaction and across a daemon
kill (tested).

Fault model: the daemon survives any compaction failure with capped
exponential backoff (a persistently failing store degrades to
delta-serving, it does not spin), and ``stats()`` surfaces
``compaction_failures`` / ``last_compaction_error`` so the operator sees
a sick compactor instead of a silently growing delta tier. A
crash-restart resumes from the last committed manifest: constructing an
:class:`IngestingRouter` over an existing durable ``workdir`` recovers
the store (``MutableIndex.recover``) and serves it immediately — every
acknowledged (manifest-committed) append survives.

On the card: the store (``MutableIndex``) lives on one device — a base
index's, or ``device`` when the router starts empty or recovers — and a
batch that is already a tensor on it is appended without a copy; host
data is uploaded once, by Stage 2.

This is the JAX package's ``repro.serving.ingest`` over the port's store
and router, with the same names and ``stats()`` keys.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

import torch

from repro_torch.core import durable
from repro_torch.core.index import ParISIndex, build_sharded_index
from repro_torch.core.ingest import (
    CompactionPolicy, CompactionResult, IngestPipeline, MutableIndex,
)
from repro_torch.serving.router import ShardedSearchRouter


class IngestingRouter:
    """A :class:`~repro_torch.serving.router.ShardedSearchRouter` that grows.

    Parameters
    ----------
    base:            the starting datastore — a built :class:`ParISIndex`,
                     a :class:`MutableIndex` (possibly already holding
                     deltas), or None with ``series_length`` to start
                     empty.
    num_base_shards: how many file-order shards the base index is split
                     into (and re-split into after every compaction).
    compaction_policy: leveled compaction trigger; the background daemon
                     (``start()``) evaluates ``policy.plan`` every
                     ``compact_tick_ms`` and runs the due tier fold.
                     Pass None to disable automatic compaction
                     (``compact_now()`` still works).
    compact_backoff_cap_ms: ceiling for the daemon's exponential backoff
                     after a failed compaction (the retry delay doubles
                     from ``compact_tick_ms`` per consecutive failure,
                     capped here; one success resets it).
    chunk_series:    re-chunk big appended batches into delta shards of at
                     most this many series (None = one shard per batch).
    series_length:   required when ``base`` is None and ``workdir`` holds
                     no recoverable store.
    workdir:         make the underlying store durable (``e{N}`` spill +
                     versioned manifest — see ``core.durable``). If the
                     directory already holds a committed manifest and
                     ``base`` is None, the store is RECOVERED and served
                     as-is (crash-restart resume: every acknowledged
                     append is queryable again on construction).
    fault_injector:  a :class:`~repro_torch.serving.faults.FaultInjector`
                     shared with the router; its compaction rules bite
                     the daemon tick (``"tick"``) and the window between
                     a finished fold and the router rewire (``"swap"``).
    device:          where an empty or recovered store lives (``"cuda"``
                     unless the caller asks for the CPU); a ``base`` keeps
                     its own device.
    **router_knobs:  forwarded to :class:`ShardedSearchRouter` (k,
                     replicas, hedging, max_batch, admission control,
                     engine knobs ...).

    ``submit``/``search_batch``/``poll``/``drain``/``stats`` delegate to
    the router; ``append`` ingests a batch and registers its delta
    shard(s); the daemon folds the due tier (deltas into a run, or base +
    runs into a new base) and reconciles the router atomically per fold.
    """

    def __init__(
        self,
        base: Union[ParISIndex, MutableIndex, None],
        num_base_shards: int = 1,
        *,
        compaction_policy: Optional[CompactionPolicy] = CompactionPolicy(),
        compact_tick_ms: float = 20.0,
        compact_backoff_cap_ms: float = 5000.0,
        chunk_series: Optional[int] = None,
        series_length: Optional[int] = None,
        workdir: Optional[str] = None,
        fault_injector=None,
        device="cuda",
        **router_knobs,
    ):
        if num_base_shards < 1:
            raise ValueError("num_base_shards must be >= 1")
        if isinstance(base, MutableIndex):
            if workdir is not None:
                # Silently dropping workdir would leave the operator
                # believing appends are durable when nothing spills.
                raise ValueError(
                    "workdir cannot be combined with a MutableIndex base "
                    "— construct the store with workdir= (or "
                    "MutableIndex.recover) and pass it in")
            self.mutable = base
        elif (base is None and workdir is not None
              and durable.read_manifest(workdir) is not None):
            # Crash-restart resume: the workdir already holds a committed
            # store — reopen it at the last manifest and serve it, rather
            # than refusing (the operator's restart command should not
            # differ from the cold-start command).
            self.mutable = MutableIndex.recover(workdir, device=device)
        else:
            if base is not None and workdir is not None \
                    and durable.read_manifest(workdir) is not None:
                raise ValueError(
                    f"{workdir} already holds a durable store; pass "
                    "base=None to recover and serve it, or a fresh "
                    "workdir to start over")
            self.mutable = MutableIndex(
                base, series_length=series_length, workdir=workdir,
                device=device if base is None else base.device)
        self.num_base_shards = num_base_shards
        self.policy = compaction_policy
        self.compact_tick_ms = compact_tick_ms
        self.compact_backoff_cap_ms = compact_backoff_cap_ms
        self._injector = fault_injector
        self.pipeline = IngestPipeline(self.mutable, chunk_series=chunk_series)
        self.router = ShardedSearchRouter(
            None, fault_injector=fault_injector, **router_knobs)
        # Service-level bookkeeping: which router shard ids implement the
        # current base and each live run/delta component. Guarded by _svc
        # so appends and the compaction rewire never race the sid maps.
        # Values keep a strong ref to the component: the maps are keyed
        # by id(), and a collected component's id could be reused.
        self._svc = threading.Lock()
        self._base_obj: Optional[ParISIndex] = None
        self._base_sids: List[int] = []
        self._runs: Dict[int, Tuple[object, int]] = {}  # id(run) -> (run, sid)
        self._deltas: Dict[int, Tuple[object, int]] = {}
        self._cold: Dict[int, Tuple[object, int]] = {}  # id(shard) -> (.., sid)
        self._daemon_lock = threading.Lock()
        self._compaction_failures = 0
        self._last_compaction_error: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._reconcile()

    # ------------------------------------------------------------- rewire
    def _reconcile(self) -> None:
        """Make the router's shard set match the live snapshot (atomic).

        Diffs the published snapshot's components (base / runs / deltas)
        against what is attached and applies the whole difference in ONE
        ``swap_shards`` transition — retiring folded components and
        attaching their replacement together keeps coverage exact; two
        separate transitions would expose a double- or un-covered file
        range in the window between them. A no-diff call does nothing,
        so the daemon runs this every tick as self-healing: a rewire the
        previous cycle missed (killed mid-swap) completes here.
        """
        with self._svc:
            snap = self.mutable.snapshot()
            want_runs = {id(r): r for r in snap.runs}
            want_deltas = {id(d): d for d in snap.deltas}
            want_cold = {id(c): c for c in snap.cold}
            retire: List[int] = []
            for key in [k for k in self._runs if k not in want_runs]:
                retire.append(self._runs.pop(key)[1])
            for key in [k for k in self._deltas if k not in want_deltas]:
                retire.append(self._deltas.pop(key)[1])
            for key in [k for k in self._cold if k not in want_cold]:
                retire.append(self._cold.pop(key)[1])
            new_runs = [r for k, r in want_runs.items()
                        if k not in self._runs]
            new_deltas = [d for k, d in want_deltas.items()
                          if k not in self._deltas]
            # A demotion publishes a new cold shard (and a fresh empty
            # base): the cold shard attaches like any other component —
            # the router builds it a disk-backed engine (ColdShard
            # dispatch in ``_register``) over the same file range the
            # retired base shards covered.
            new_cold = [c for k, c in want_cold.items()
                        if k not in self._cold]
            base_changed = snap.base is not self._base_obj
            base_pairs: List[Tuple[ParISIndex, int]] = []
            if base_changed:
                retire += self._base_sids
                if snap.base.num_series:
                    shards = min(self.num_base_shards, snap.base.num_series)
                    sharded = build_sharded_index(snap.base, shards)
                    base_pairs = [(ix, off + snap.base_offset)
                                  for ix, off in zip(sharded.shards,
                                                     sharded.offsets)]
            add = (base_pairs
                   + [(r.index, r.base) for r in new_runs]
                   + [(d.index, d.base) for d in new_deltas]
                   + [(c, c.base) for c in new_cold])
            if not retire and not add:
                return
            sids = self.router.swap_shards(retire, add)
            nb = len(base_pairs)
            nr = len(new_runs)
            nd = len(new_deltas)
            if base_changed:
                self._base_obj = snap.base
                self._base_sids = sids[:nb]
            for r, sid in zip(new_runs, sids[nb:nb + nr]):
                self._runs[id(r)] = (r, sid)
            for d, sid in zip(new_deltas, sids[nb + nr:nb + nr + nd]):
                self._deltas[id(d)] = (d, sid)
            for c, sid in zip(new_cold, sids[nb + nr + nd:]):
                self._cold[id(c)] = (c, sid)

    # -------------------------------------------------------------- ingest
    def append(self, batch) -> int:
        """Ingest one (B, n) batch; series are queryable on return.

        Each resulting delta shard attaches to the router with its own
        admission-controlled replica group + engine. ``batch`` is a host
        array (uploaded once) or a tensor on the store's device (used
        where it lies). Returns the number of series appended.
        """
        if not isinstance(batch, torch.Tensor):
            batch = np.asarray(batch, np.float32)
        with self._svc:
            for delta in self.pipeline.append(batch):
                if id(delta) not in self._deltas:
                    self._deltas[id(delta)] = (
                        delta,
                        self.router.add_shard(delta.index, delta.base))
        return len(batch)

    # ---------------------------------------------------------- compaction
    def compact_now(self, tier: str = "full",
                    demote: bool = False) -> Optional[CompactionResult]:
        """Run one tier fold (if it has anything) and rewire the router.

        The merge runs without holding the service lock — appends and
        queries proceed; only the reconcile at the end is locked. A
        minor fold swaps the folded delta shards for the new run shard
        (the base shards never move); a major/full fold swaps the base
        shards + folded run/delta shards for the resharded new base.
        ``demote=True`` (durable stores) sends the major/full fold to
        the COLD tier instead — the retired base shards' file range is
        re-covered by one disk-backed ColdShard replica group.
        """
        res = self.mutable.compact(tier=tier, demote=demote)
        if res is None:
            return None
        if self._injector is not None:
            # The nastiest window: the fold is published (and, durable,
            # committed) but the router still serves the old components.
            self._injector.on_compaction("swap")
        self._reconcile()
        return res

    def _compact_loop(self):
        tick = max(self.compact_tick_ms, 1.0) / 1e3
        cap = max(self.compact_backoff_cap_ms / 1e3, tick)
        streak = 0
        wait = tick
        while not self._stop_evt.wait(wait):
            try:
                if self._injector is not None:
                    self._injector.on_compaction("tick")
                # Self-healing first: finish any rewire a previous cycle
                # died in the middle of before planning new work.
                self._reconcile()
                if self.policy is not None:
                    tier = self.policy.plan(self.mutable.snapshot())
                    if tier is not None:
                        self.compact_now(
                            tier=tier,
                            demote=(self.policy.demote_major
                                    and self.mutable.durable
                                    and tier in ("major", "full")))
                streak = 0
                wait = tick
            except Exception as e:  # noqa: BLE001 — daemon must survive
                # A failed compaction leaves the old (complete) view
                # serving; back off exponentially (capped) so a
                # persistently failing store does not spin the core,
                # and surface the failure in stats().
                with self._daemon_lock:
                    self._compaction_failures += 1
                    self._last_compaction_error = repr(e)
                streak += 1
                wait = min(tick * (2.0 ** streak), cap)

    # ----------------------------------------------------------- lifecycle
    def start(self, tick_ms: Optional[float] = None) -> None:
        """Start the per-replica flushers and the compaction daemon."""
        self.router.start(tick_ms)
        if self._thread is None and self.policy is not None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._compact_loop, name="compaction", daemon=True)
            self._thread.start()

    def stop(self, drain: bool = True, compact: bool = False) -> None:
        """Stop daemons; optionally run one final compaction."""
        if self._thread is not None:
            self._stop_evt.set()
            self._thread.join()
            self._thread = None
        if compact:
            self.compact_now()
        self.router.stop(drain=drain)

    # ------------------------------------------------------------- queries
    @property
    def num_series(self) -> int:
        """Series in the live (queryable) view."""
        return self.mutable.num_series

    def submit(self, query, *, deadline_ms: Optional[float] = None,
               tier=None) -> Future:
        """Submit one query at an optional service tier (router passthrough).

        Tiered answers stay guarantee-true mid-ingest: every delta shard
        answers at the request's tier over its own partition, and the
        cross-shard achieved bound combines conservatively in the merge.
        """
        return self.router.submit(query, deadline_ms=deadline_ms, tier=tier)

    def search_batch(self, queries, *, tier=None):
        """Routed batch search over the live view (tiered when ``tier`` is)."""
        return self.router.search_batch(queries, tier=tier)

    def poll(self) -> int:
        """Delegate to :meth:`ShardedSearchRouter.poll`."""
        return self.router.poll()

    def drain(self) -> int:
        """Delegate to :meth:`ShardedSearchRouter.drain`."""
        return self.router.drain()

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Router saturation counters + ingest/compaction figures."""
        s = self.router.stats()
        s["ingest"] = self.mutable.stats()
        s["ingest"]["series_per_sec"] = self.pipeline.stats.series_per_sec
        with self._daemon_lock:
            s["compaction_failures"] = self._compaction_failures
            s["last_compaction_error"] = self._last_compaction_error
        return s

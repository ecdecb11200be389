"""Live ingestion: a leveled, durable, snapshot-swapped mutable index.

Counterpart of ``repro/core/ingest.py``: series are inserted *while
queries are in flight*, with exact answers at every point, by an LSM-style
store built out of pieces the offline pipeline already has. Components
live on the store's device (the card unless the caller asks for the CPU).

  * :class:`DeltaShard` — a small immutable index over one appended batch,
    produced by the builder's Stage 2
    (:func:`~repro_torch.core.build_pipeline.bulk_load_chunk`: z-norm ->
    the ``paa_isax`` kernel -> sortable packed refine keys -> stable
    presort into leaf order), with shard-local positions plus a global
    file offset.
  * :class:`MutableIndex` — base + run + delta tiers behind an atomically
    swapped immutable :class:`Snapshot`. Readers grab the current snapshot
    (one attribute read) and see a consistent, complete view for the whole
    query; writers (append / compaction publish) swap in a new snapshot
    under a lock.
  * leveled compaction — deltas fold into one run (minor, base untouched),
    base + runs fold into a new base (major), or everything at once
    (full). Every merge is a linear
    :func:`~repro_torch.core.build_pipeline.merge_runs` pass on the
    device, bounded by its tier; merges run outside all locks.
  * durability (``core.durable``) — with a ``workdir`` every component
    spills to an ``e{N}`` dir and every acknowledged transition commits a
    versioned manifest BEFORE the in-memory swap: spill -> manifest
    commit -> publish -> GC. Appends pipeline their spills through commit
    tickets and group-commit the contiguous spilled prefix. The files are
    byte for byte the reference's, so either package recovers a store the
    other spilled (:meth:`MutableIndex.recover`).
  * fused search — with several live components, one
    ``lower_bound_sq_multi`` sweep over the snapshot's packed view and one
    RDC loop, through the engine's front door like every other store
    (``search._engine_call`` over ``search._packed_view``).
  * the cold tier (``core.coldtier``) — :meth:`MutableIndex.demote` sends
    the folded base to disk; its summaries stay on the device.
  * spans — under a profiler each k-NN search (``exact_knn_batch``,
    ``knn_batch_tiered``) is one ``paris.live`` range holding
    ``paris.live.pack`` (the packed view, cached or updated) and the
    engine's own ``paris.engine`` ranges, or ``paris.live.merge`` (the
    per-component engines and their merge); :meth:`MutableIndex.stats`
    counts every search's path (``fused_calls``, ``component_calls``).

Snapshots stay exact while later ones are built, which JAX's immutable
arrays gave the reference for free: no published tensor is ever written.
Folds and appends make new tensors; the one in-place write is the packed
view's raw buffer growing into its spare capacity, at rows past every
published snapshot's series (see :class:`IncrementalPacker`).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
import weakref
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import coldtier, durable, isax, search, trace
from repro_torch.core.block_cache import BlockCache
from repro_torch.core.build_pipeline import (
    _stage2, keys_from_u64, keys_to_u64, merge_runs, refine_key,
)
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.index import ParISIndex, assemble_index, empty_index
from repro_torch.core.search import (
    INF, NO_POS, PackedComponents, SearchConfig, SearchResult, _pack_block,
    _tier_list, exact_knn_batch, exact_search_batch, knn_batch_tiered,
    merge_top_lists, pack_components, pack_one_component, packed_seed,
)

# Rows copied to the device per step when a recovered component's memory-
# mapped raw is uploaded, and rows gathered per step into a cold epoch's
# leaf-order raw on the host: bounds the host copies to 256 MiB at n = 256.
UPLOAD_ROWS = 1 << 18


@dataclasses.dataclass(frozen=True)
class DeltaShard:
    """One immutable leaf-ordered component above the base.

    Both non-base tiers use this shape: a freshly appended batch (delta
    tier) and a minor-compacted fold of several deltas (run tier).
    ``index`` holds shard-local positions (0-based); the shard owns the
    contiguous global file range ``[base, base + num_series)``. ``keys``
    caches the sorted sortable refine keys (int64, see
    ``core.build_pipeline``) so compaction can linear-merge this run
    without recomputing them. ``dir`` is the component's epoch dir name
    when the store is durable (None in memory-only mode).
    """

    index: ParISIndex
    keys: torch.Tensor  # (m,) int64 sortable, sorted — the leaf-order run
    base: int  # global file offset of the shard's first series
    dir: Optional[str] = None  # e{N} dir under the store's workdir

    @property
    def num_series(self) -> int:
        """Series in this delta shard."""
        return self.index.num_series


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """An immutable, complete view of the mutable index at one instant.

    The tiers in ascending file-offset order: ``cold`` (demoted epochs —
    raw on disk, summaries on the device) owns ``[0, base_offset)``,
    ``base`` covers ``[base_offset, base_offset + base.num_series)``,
    ``runs`` (minor-compaction output) the next contiguous ranges,
    ``deltas`` (raw appends) the newest ranges at the tail.
    ``components()`` lists the IN-MEMORY tiers as (index, offset) pairs
    in that order; readers serve ``cold`` through its own disk-backed
    engine and merge. ``base_keys`` rides along so compaction never
    recomputes the base run's keys.
    """

    base: ParISIndex
    base_keys: torch.Tensor  # (N_base,) int64 sortable, sorted
    runs: Tuple[DeltaShard, ...] = ()
    deltas: Tuple[DeltaShard, ...] = ()
    version: int = 0
    cold: Tuple[coldtier.ColdShard, ...] = ()  # ascending, from offset 0
    base_offset: int = 0  # where the hot base starts (== total cold)

    @property
    def num_series(self) -> int:
        """Total series visible in this snapshot (all tiers)."""
        return (sum(c.num_series for c in self.cold)
                + self.base.num_series
                + sum(r.num_series for r in self.runs)
                + sum(d.num_series for d in self.deltas))

    def components(self) -> list:
        """In-memory (index, file offset) pairs, ascending offset order."""
        out = []
        if self.base.num_series:
            out.append((self.base, self.base_offset))
        out.extend((r.index, r.base) for r in self.runs)
        out.extend((d.index, d.base) for d in self.deltas)
        return out


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Two-tier trigger: which fold (if any) a snapshot is due for.

    Delta tier (minor trigger — fold deltas into ONE run, base untouched):
    ``max_deltas`` shards or ``max_delta_series`` total series. Run tier
    (major trigger — fold base + runs into a new base): the run tier has
    grown to ``major_ratio`` of the base (a size ratio, so only O(log N)
    majors happen over a store's life). A store with runs but an EMPTY
    base is always major-due. ``leveled=False`` makes the delta trigger
    fold EVERYTHING into the base (the unbounded baseline).
    ``demote_major=True`` turns every major fold of a durable store into
    a demotion to the cold tier (``core.coldtier``).
    """

    max_deltas: int = 4
    max_delta_series: Optional[int] = None
    major_ratio: float = 0.5
    leveled: bool = True
    demote_major: bool = False

    def __post_init__(self):
        if not self.major_ratio > 0:
            raise ValueError(
                f"major_ratio must be > 0, got {self.major_ratio}")

    def plan(self, snapshot: Snapshot) -> Optional[str]:
        """The due fold: "minor", "major", "full", or None (not due)."""
        nd = len(snapshot.deltas)
        delta_due = nd > 0 and (
            nd >= self.max_deltas
            or (self.max_delta_series is not None
                and sum(d.num_series for d in snapshot.deltas)
                >= self.max_delta_series))
        if not self.leveled:
            return "full" if delta_due else None
        run_series = sum(r.num_series for r in snapshot.runs)
        run_due = run_series > 0 and (
            run_series >= self.major_ratio * snapshot.base.num_series)
        if run_due:
            return "major"
        if delta_due:
            return "minor"
        return None

    def should_compact(self, snapshot: Snapshot) -> bool:
        """Whether :meth:`plan` picks any fold for this snapshot."""
        return self.plan(snapshot) is not None


@dataclasses.dataclass(frozen=True)
class CompactionResult:
    """What one compaction did (and what the serving layer must rewire)."""

    tier: str  # "minor" | "major" | "full"
    base: Optional[ParISIndex]  # new base ("major"/"full"), else None
    run: Optional[DeltaShard]  # new run ("minor"), else None
    retired_runs: Tuple[DeltaShard, ...]
    retired_deltas: Tuple[DeltaShard, ...]
    snapshot: Snapshot  # the published post-compaction snapshot
    merge_time: float  # seconds spent merging (unlocked, concurrent)
    stall_time: float  # seconds writers were blocked by the publish swap
    cold: Optional[coldtier.ColdShard] = None  # the demoted epoch, if any

    @property
    def retired(self) -> Tuple[DeltaShard, ...]:
        """Every folded component, offset-ascending (compat helper)."""
        return self.retired_runs + self.retired_deltas


def _convert_batch(
    batch,
    *,
    segments: int,
    cardinality: int,
    refine_bits: int,
    impl: str,
    device: torch.device,
) -> tuple:
    """Stage 2 on one appended batch: (sorted keys, shard-local index).

    Identical math to the builder's per-chunk task (znorm -> paa_isax ->
    refine keys -> presort). Positions are shard-local (offset 0), so the
    conversion needs no knowledge of where the shard will land in the
    global file order — appenders run it OUTSIDE the snapshot lock.
    """
    if not isinstance(batch, torch.Tensor):
        batch = np.asarray(batch, np.float32)
    if batch.ndim != 2 or batch.shape[0] == 0:
        raise ValueError(
            f"append takes a non-empty (B, n) batch, got "
            f"{tuple(batch.shape)}")
    x, keys, sax, pos = _stage2(
        batch, 0, segments=segments, cardinality=cardinality,
        refine_bits=refine_bits,
        breakpoints=isax.gaussian_breakpoints(cardinality, device),
        impl=impl, presort=True, device=device)
    return keys, assemble_index(sax, pos, x, segments, cardinality)


def build_delta_shard(
    batch,
    base: int,
    *,
    segments: int = isax.DEFAULT_SEGMENTS,
    cardinality: int = isax.DEFAULT_CARDINALITY,
    refine_bits: int = 4,
    impl: str = "auto",
    device="cuda",
) -> DeltaShard:
    """Convert one appended batch into a sorted delta shard at ``base``.

    The global placement lives only in ``base``, exactly like a
    :class:`~repro_torch.core.index.ShardedIndex` shard.
    """
    keys, index = _convert_batch(
        batch, segments=segments, cardinality=cardinality,
        refine_bits=refine_bits, impl=impl, device=resolve_device(device))
    return DeltaShard(index=index, keys=keys, base=base)


class IncrementalPacker:
    """Grows one snapshot's packed view into the next in O(delta) host work.

    A snapshot swap only changes the TAIL of the (base, runs..., deltas...)
    component list, so the longest component prefix shared with the
    previously packed snapshot (matched by object identity) keeps its
    packed blocks; only the suffix is re-packed through
    :func:`~repro_torch.core.search.pack_one_component`. Buffers are
    capacity-padded with ~12.5% headroom; dead tail blocks carry
    ``block_len == 0`` (every lane +inf).

    No tensor a published :class:`PackedComponents` holds is written:

      * the SAX, ``gpos`` and ``block_len`` buffers are built anew on every
        update (a fold rewrites the tail an older snapshot may still be
        sweeping, and a write into a dead block would make it live for
        every snapshot sharing ``block_len``);
      * the raw buffer is file-order, and a fold keeps file order, so it
        only ever APPENDS rows: new rows go into its spare capacity, past
        every row an older snapshot can gather (its positions stop at its
        own series count). Only a capacity overflow allocates a new buffer
        (old and new raw then coexist while older snapshots hold the old).

    The prefix is matched through weak references: the packer keeps no
    retired component (and its raw) alive.
    """

    def __init__(self, block: int, series_length: int, segments: int,
                 cardinality: int, device="cuda"):
        self.block = block
        self.series_length = series_length
        self.segments = segments
        self.cardinality = cardinality
        self.device = resolve_device(device)
        # (weakref to the component index, offset, n_blocks) per component.
        self._entries: list = []
        self._sax = None
        self._gpos = None
        self._bl = None
        self._raw = None
        self._cap_blocks = 0
        self._cap_raw = 0
        self._used_raw = 0
        self._version: Optional[int] = None

    def update(self, snap: Snapshot) -> tuple:
        """Pack ``snap``, reusing the previous pack's unchanged prefix.

        Returns ``(PackedComponents, rows_repacked)`` — the second term
        is the O(delta) the caller's stats surface (suffix SAX rows plus
        appended raw rows; a scratch pack counts everything).
        """
        comps = [(ix, off) for ix, off in snap.components()
                 if ix.num_series]
        if not comps:
            raise ValueError("packed view needs at least one nonempty "
                             "component")
        if self._version is not None and snap.version <= self._version:
            # A query racing on an OLDER snapshot than the packer has
            # advanced to: serve it a scratch pack instead of regressing
            # the shared buffers (rare — only mid-swap stragglers).
            packed = pack_components(comps, block=self.block)
            return packed, packed.num_series
        expect = 0
        for ix, off in comps:
            if off != expect:
                raise ValueError(
                    f"components not contiguous: offset {off}, expected "
                    f"{expect}")
            expect += ix.num_series
        total = expect
        b = self.block

        # --- longest shared component prefix (identity + placement) ---
        p = 0
        while (p < len(self._entries) and p < len(comps)
               and comps[p][0] is self._entries[p][0]()
               and comps[p][1] == self._entries[p][1]):
            p += 1
        prefix_blocks = sum(e[2] for e in self._entries[:p])
        entries = list(self._entries[:p])
        sax_parts, gp_parts, bl_parts = [], [], []
        for ix, off in comps[p:]:
            sax, gp, bl = pack_one_component(ix, off, b)
            sax_parts.append(sax)
            gp_parts.append(gp)
            bl_parts.append(bl)
            entries.append((weakref.ref(ix), off, len(bl)))
        suffix_blocks = sum(len(x) for x in bl_parts)
        used_blocks = prefix_blocks + suffix_blocks
        rows = suffix_blocks * b

        # --- SAX / gpos / block_len: prefix + suffix + dead tail, anew ---
        if used_blocks > self._cap_blocks or self._sax is None:
            cap = used_blocks + max(used_blocks // 8, 4)
            self._cap_blocks = -(-cap // 4) * 4
        pad_blocks = self._cap_blocks - used_blocks
        w = self.segments
        dev = self.device
        parts_sax, parts_gp, parts_bl = [], [], []
        if prefix_blocks:
            parts_sax.append(self._sax[: prefix_blocks * b])
            parts_gp.append(self._gpos[: prefix_blocks * b])
            parts_bl.append(self._bl[:prefix_blocks])
        parts_sax += sax_parts
        parts_gp += gp_parts
        parts_bl += bl_parts
        if pad_blocks:
            parts_sax.append(torch.zeros((pad_blocks * b, w),
                                         dtype=torch.uint8, device=dev))
            parts_gp.append(torch.full((pad_blocks * b,), NO_POS,
                                       dtype=torch.int32, device=dev))
            parts_bl.append(torch.zeros((pad_blocks,), dtype=torch.int32,
                                        device=dev))
        self._sax = torch.cat(parts_sax)
        self._gpos = torch.cat(parts_gp)
        self._bl = torch.cat(parts_bl)

        # --- raw: file-order invariant under folds — append-only ---
        if total > self._used_raw or self._raw is None:
            used = self._used_raw
            if self._raw is None or total > self._cap_raw:
                # Raw rows are only touched by per-candidate gathers, not
                # the sweep — headroom here costs memory, not query time.
                self._cap_raw = total + max(total // 8, self.block)
                grown = torch.empty((self._cap_raw, self.series_length),
                                    dtype=torch.float32, device=dev)
                if used:
                    grown[:used] = self._raw[:used]
                grown[total:] = 0
                self._raw = grown
            at = used
            for ix, off in comps:  # rows [used, total), into spare capacity
                if off + ix.num_series > used:
                    piece = ix.raw[max(0, used - off):]
                    self._raw[at:at + piece.shape[0]] = piece
                    at += piece.shape[0]
            rows += total - used
            self._used_raw = total

        self._entries = entries
        self._version = snap.version
        packed = PackedComponents(
            sax=self._sax, gpos=self._gpos, block_len=self._bl,
            raw=self._raw, num_series=total, block=b,
            series_length=self.series_length, segments=self.segments,
            cardinality=self.cardinality,
        )
        return packed, rows


class _SpillTicket:
    """One durable append's place in the commit order.

    A ticket is allocated under ``_ticket_lock`` (reserving the batch's
    global file offset and its ``e{N}`` dir) BEFORE the spill starts, so
    any number of appenders can spill concurrently while manifests still
    commit in offset order: a ticket becomes committable only when every
    ticket before it has spilled. ``event`` fires when the ticket is
    committed (success) or poisoned (its own spill failed, an EARLIER
    ticket failed, or the group's manifest commit failed).
    """

    __slots__ = ("seq", "delta", "state", "error", "event", "t0")

    def __init__(self, seq: int, delta: DeltaShard, t0: float):
        self.seq = seq
        self.delta = delta
        self.state = "spilling"  # -> "spilled" -> committed | "failed"
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.t0 = t0


def _upload(arr, dtype, device: torch.device) -> torch.Tensor:
    """A host (possibly memory-mapped) array -> a tensor on ``device``.

    Copied ``UPLOAD_ROWS`` rows at a time, so a mapped file enters host
    memory one piece at a time on its way to the device.
    """
    out = torch.empty(arr.shape, dtype=dtype, device=device)
    for s in range(0, arr.shape[0], UPLOAD_ROWS):
        piece = np.array(arr[s:s + UPLOAD_ROWS])
        out[s:s + piece.shape[0]] = torch.from_numpy(piece)
    return out


def _index_from_files(keys, sax, pos, raw, segments: int, cardinality: int,
                      device: torch.device) -> tuple:
    """(sortable keys, index) on ``device`` from a component's host arrays."""
    index = assemble_index(
        _upload(sax, torch.uint8, device), _upload(pos, torch.int32, device),
        _upload(raw, torch.float32, device), segments, cardinality)
    return keys_from_u64(keys, device), index


class MutableIndex:
    """A growing exact-search index: leveled tiers, snapshot-swapped.

    Readers never lock: :meth:`snapshot` returns the current immutable
    view and every search method runs entirely against one snapshot.
    Writers serialize on ``_mutate`` (appends and the compaction publish);
    at most one compaction runs at a time (``_compact``), and its merge
    phase holds neither lock, so queries AND appends proceed while a tier
    is being folded.

    ``workdir`` makes the store durable: components spill to ``e{N}``
    dirs and every acknowledged transition commits a versioned manifest
    before it publishes (see ``core.durable``). Durable appends are
    PIPELINED: each one reserves a commit ticket (offset + epoch dir)
    under a short lock, spills its shard with no lock held, then the
    contiguous spilled prefix of the ticket queue commits in ONE manifest
    under ``_commit``. ``fault`` is the crash-injection hook (tests only)
    — once a fault fires, the in-memory object must be abandoned and the
    store reopened with :meth:`recover`, exactly like a real crash.

    ``refine_bits`` must match the value the base was built with (the
    builder's default, 4). The store lives on ``device``; a ``base`` must
    already be there.
    """

    def __init__(
        self,
        base: Optional[ParISIndex] = None,
        *,
        series_length: Optional[int] = None,
        segments: int = isax.DEFAULT_SEGMENTS,
        cardinality: int = isax.DEFAULT_CARDINALITY,
        refine_bits: int = 4,
        impl: str = "auto",
        workdir: Optional[str] = None,
        fault: durable.Fault = None,
        pack_block: Optional[int] = None,
        cold_cache: Optional[BlockCache] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if base is None:
            if series_length is None:
                raise ValueError(
                    "series_length is required when starting empty")
            base = empty_index(series_length, segments, cardinality,
                               device=self.device)
        elif base.device != self.device:
            raise ValueError(
                f"base index on {base.device}, store on {self.device}")
        self.segments = base.segments
        self.cardinality = base.cardinality
        self.series_length = base.series_length
        self.refine_bits = refine_bits
        self.impl = impl
        self.pack_block = _pack_block(pack_block, base.num_series,
                                      self.device)
        base_keys = refine_key(base.sax, refine_bits, base.cardinality)
        self._snapshot = Snapshot(base, base_keys)
        self._cold_cache = (cold_cache if cold_cache is not None
                            else BlockCache())
        self._init_runtime()
        self.workdir = workdir
        self._fault = fault
        self._next_epoch = 0
        self._base_ref: Optional[durable.ComponentRef] = None
        if workdir is not None:
            os.makedirs(workdir, exist_ok=True)
            if durable.read_manifest(workdir) is not None:
                raise ValueError(
                    f"{workdir} already holds a durable store; open it "
                    "with MutableIndex.recover() instead")
            if base.num_series:
                self._base_ref = self._spill_index(
                    self._alloc_epoch(), base_keys, base, 0)
            durable.write_manifest(
                workdir, self._manifest_for(self._snapshot), fault)

    def _init_runtime(self) -> None:
        self._mutate = threading.Lock()
        self._compact = threading.Lock()
        self._commit = threading.Lock()  # manifests land in ticket order
        self._pack = threading.Lock()
        self._count = threading.Lock()  # readers' call counters
        self._ticket_lock = threading.Lock()  # queue + offset/epoch alloc
        self._spill_queue: List[_SpillTicket] = []  # uncommitted, seq order
        self._spill_seq = 0
        self._tail: Optional[int] = None  # next reserved global offset
        self._packer = IncrementalPacker(
            self.pack_block, self.series_length, self.segments,
            self.cardinality, self.device)
        self._stats = dict(
            appends=0, appended_series=0, convert_time=0.0,
            compactions=0, compacted_series=0,
            demotions=0, demoted_series=0,
            merge_time=0.0, stall_time_max=0.0,
            spills=0, spill_time=0.0, group_commits=0,
            spill_queue_depth_max=0,
            pack_builds=0, pack_time=0.0, pack_time_max=0.0,
            pack_rows_repacked=0,
            fused_calls=0, component_calls=0,
        )

    # ---------------------------------------------------------- durability
    @property
    def durable(self) -> bool:
        """Whether spills/commits are enabled (a workdir was given)."""
        return self.workdir is not None

    def _alloc_epoch(self) -> str:
        """Next ``e{N}`` dir name (under ``_ticket_lock`` once concurrent).

        An allocated number may never commit — a poisoned ticket's dir
        stays an orphan until recovery sweeps it — so ``next_epoch`` in a
        manifest only promises "first unused", not "densely used".
        """
        name = f"e{self._next_epoch}"
        self._next_epoch += 1
        return name

    def _manifest_for(self, snap: Snapshot) -> durable.Manifest:
        def ref(s: DeltaShard) -> durable.ComponentRef:
            if s.dir is None:
                raise RuntimeError("durable component without a dir")
            return durable.ComponentRef(s.dir, s.base, s.num_series)

        return durable.Manifest(
            version=snap.version,
            next_epoch=self._next_epoch,
            series_length=self.series_length,
            segments=self.segments,
            cardinality=self.cardinality,
            refine_bits=self.refine_bits,
            base=self._base_ref,
            runs=tuple(ref(r) for r in snap.runs),
            deltas=tuple(ref(d) for d in snap.deltas),
            cold=tuple(durable.ComponentRef(c.dir, c.base, c.num_series)
                       for c in snap.cold),
        )

    def _spill_index(self, name: str, keys: torch.Tensor, index: ParISIndex,
                     offset: int) -> durable.ComponentRef:
        """Spill one in-memory component as host arrays (uint64 keys)."""
        return durable.spill_component(
            self.workdir, name, keys_to_u64(keys), index.sax.cpu().numpy(),
            index.pos.cpu().numpy(), index.raw.cpu().numpy(), base=offset,
            series_length=self.series_length, fault=self._fault)

    def _spill_shard(
        self, name: str, keys: torch.Tensor, index: ParISIndex, offset: int
    ) -> None:
        t0 = time.perf_counter()
        self._spill_index(name, keys, index, offset)
        dt = time.perf_counter() - t0
        with self._mutate:
            self._stats["spills"] += 1
            self._stats["spill_time"] += dt

    def _spill_cold(
        self, name: str, keys: torch.Tensor, merged: ParISIndex, offset: int
    ) -> coldtier.ColdShard:
        """Spill ``merged`` as a cold epoch and commit its catalog entry.

        Steps 1-2 of the demotion protocol: raw rows are PERMUTED TO
        LEAF ORDER on the way out (each bucket becomes one contiguous
        byte range), then the catalog entry commits atomically. The
        manifest has NOT moved yet: a crash after this leaves a catalog
        entry recovery prunes, never a visible state change. The leaf-
        order raw is gathered on the device and copied to the host in
        pieces, so the device never holds a second full raw matrix.
        """
        t0 = time.perf_counter()
        m = merged.num_series
        raw_leaf = np.empty((m, self.series_length), np.float32)
        for s in range(0, m, UPLOAD_ROWS):
            rows = merged.pos[s:s + UPLOAD_ROWS].long()
            raw_leaf[s:s + rows.shape[0]] = merged.raw[rows].cpu().numpy()
        ref = coldtier.spill_cold_component(
            self.workdir, name, keys_to_u64(keys), merged.sax.cpu().numpy(),
            merged.pos.cpu().numpy(), raw_leaf, base=offset,
            series_length=self.series_length, fault=self._fault)
        del raw_leaf
        entry = coldtier.epoch_entry(
            self.workdir, name, base=offset,
            num_series=m,
            series_length=self.series_length,
            bucket_offsets=merged.bucket_offsets)
        coldtier.catalog_add(self.workdir, name, entry, self._fault)
        shard = coldtier.load_cold_shard(
            self.workdir, ref, cache=self._cold_cache,
            segments=self.segments, cardinality=self.cardinality,
            device=self.device)
        dt = time.perf_counter() - t0
        with self._mutate:
            self._stats["spills"] += 1
            self._stats["spill_time"] += dt
        return shard

    @classmethod
    def recover(
        cls,
        workdir: str,
        *,
        impl: str = "auto",
        fault: durable.Fault = None,
        pack_block: Optional[int] = None,
        cold_cache: Optional[BlockCache] = None,
        device="cuda",
    ) -> "MutableIndex":
        """Reopen a durable store at its last committed manifest, on ``device``.

        The reloaded snapshot is bit-exact: every array round-trips
        through ``.npy`` losslessly and bucket offsets are rebuilt
        deterministically, so search answers equal a from-scratch build
        over every acknowledged append. The store may have been written by
        either package. Hot components stream their memory-mapped raw to
        the device in pieces; cold epochs load only their summaries — the
        raw matrix stays on disk behind ``cold_cache`` (a fresh unlimited
        :class:`~repro_torch.core.block_cache.BlockCache` by default). The
        pointer-index catalog is reconciled against the manifest, orphan
        ``e{N}`` dirs are swept, and the store resumes normal durable
        operation from ``next_epoch``.
        """
        man = durable.read_manifest(workdir)
        if man is None:
            raise ValueError(f"{workdir} holds no durable store manifest")
        self = cls.__new__(cls)
        self.device = dev = resolve_device(device)
        self.segments = man.segments
        self.cardinality = man.cardinality
        self.series_length = man.series_length
        self.refine_bits = man.refine_bits
        self.impl = impl
        self.pack_block = _pack_block(pack_block, 0, dev)
        self.workdir = workdir
        self._fault = fault
        self._next_epoch = man.next_epoch
        self._base_ref = man.base
        self._cold_cache = (cold_cache if cold_cache is not None
                            else BlockCache())

        def load(ref: durable.ComponentRef) -> tuple:
            return _index_from_files(
                *durable.load_component(workdir, ref, mmap_mode="r"),
                man.segments, man.cardinality, dev)

        if man.base is not None:
            base_keys, base = load(man.base)
        else:
            base = empty_index(man.series_length, man.segments,
                               man.cardinality, device=dev)
            base_keys = torch.zeros((0,), dtype=torch.int64, device=dev)

        def shard(ref: durable.ComponentRef) -> DeltaShard:
            keys, index = load(ref)
            return DeltaShard(index=index, keys=keys, base=ref.base,
                              dir=ref.dir)

        cold = tuple(
            coldtier.load_cold_shard(
                workdir, ref, cache=self._cold_cache,
                segments=man.segments, cardinality=man.cardinality,
                device=dev)
            for ref in man.cold)
        base_offset = (man.base.base if man.base is not None
                       else (cold[-1].base + cold[-1].num_series
                             if cold else 0))
        self._snapshot = Snapshot(
            base, base_keys,
            tuple(shard(r) for r in man.runs),
            tuple(shard(d) for d in man.deltas),
            man.version,
            cold=cold, base_offset=base_offset,
        )
        self._init_runtime()
        # Reconcile BEFORE the orphan sweep: a pruned (manifest-less)
        # catalog entry stops protecting its dir, so the sweep can then
        # reclaim the half-committed demotion.
        coldtier.reconcile_catalog(workdir, man, cold, fault)
        durable.gc_orphans(workdir, man, fault)
        return self

    # ------------------------------------------------------------- readers
    def snapshot(self) -> Snapshot:
        """The current immutable view (atomic attribute read, no lock)."""
        return self._snapshot

    @property
    def num_series(self) -> int:
        """Series in the current snapshot."""
        return self._snapshot.num_series

    @property
    def num_deltas(self) -> int:
        """Live delta shards in the current snapshot."""
        return len(self._snapshot.deltas)

    @property
    def num_runs(self) -> int:
        """Run-tier components in the current snapshot."""
        return len(self._snapshot.runs)

    # ------------------------------------------------------------- writers
    def append(self, batch) -> DeltaShard:
        """Insert a (B, n) batch of series; visible to queries on return.

        ``batch`` is a host array or a tensor on the store's device. The
        batch becomes one delta shard at the end of the global file
        order; its Stage-2 conversion runs OUTSIDE all locks (positions
        are shard-local, so it needs no offset).

        A durable store spills the shard and commits the manifest BEFORE
        the swap — the append is acknowledged only once it would survive
        a crash — through the pipelined ticket protocol:

          1. reserve, under ``_ticket_lock``: a commit ticket carrying the
             batch's global offset (the tail past every in-flight
             reservation) and its ``e{N}`` dir,
          2. spill the shard in THIS thread, no lock held,
          3. group-commit: the longest fully-spilled PREFIX of the ticket
             queue is published as ONE manifest under ``_commit``, then
             the snapshot swaps and every ticket in the group is
             acknowledged,
          4. wait for this ticket's event — set by whichever appender's
             commit included it.

        A failed spill poisons its own ticket AND every later one; the
        poisoned ``append`` calls raise, nothing past the gap is
        acknowledged, and the reserved tail rolls back.
        """
        t0 = time.perf_counter()
        keys, index = _convert_batch(
            batch, segments=self.segments, cardinality=self.cardinality,
            refine_bits=self.refine_bits, impl=self.impl,
            device=self.device,
        )
        if not self.durable:
            with self._mutate:
                snap = self._snapshot
                delta = DeltaShard(index=index, keys=keys,
                                   base=snap.num_series)
                self._publish_append(snap, delta, t0)
            return delta
        with self._ticket_lock:
            if self._tail is None:
                self._tail = self._snapshot.num_series
            name = self._alloc_epoch()
            delta = DeltaShard(index=index, keys=keys, base=self._tail,
                               dir=name)
            self._tail += index.num_series
            ticket = _SpillTicket(self._spill_seq, delta, t0)
            self._spill_seq += 1
            self._spill_queue.append(ticket)
            depth = len(self._spill_queue)
        with self._mutate:
            s = self._stats
            s["spill_queue_depth_max"] = max(
                s["spill_queue_depth_max"], depth)
        try:
            self._spill_shard(name, keys, index, delta.base)
        except BaseException as e:
            self._poison_from(ticket, e)
            raise
        with self._ticket_lock:
            if ticket.state == "spilling":
                ticket.state = "spilled"
        self._commit_spilled()
        ticket.event.wait()
        if ticket.error is not None:
            raise ticket.error
        return delta

    def _poison_from(self, ticket: _SpillTicket,
                     err: BaseException) -> None:
        """Fail ``ticket`` and every LATER queued ticket; roll back tail."""
        with self._ticket_lock:
            try:
                i = self._spill_queue.index(ticket)
            except ValueError:  # already poisoned by an earlier gap
                return
            doomed = self._spill_queue[i:]
            del self._spill_queue[i:]
            self._tail = ticket.delta.base
            for t in doomed:
                t.state = "failed"
                t.error = err if t is ticket else RuntimeError(
                    f"append aborted: an earlier durable append failed "
                    f"({err})")
                t.event.set()

    def _commit_spilled(self) -> None:
        """Group-commit the contiguous spilled prefix of the ticket queue.

        Runs in whichever appender thread gets here; if the head of the
        queue is still spilling there is nothing committable — the thread
        that completes the head commits it (every appender calls this
        after its spill).
        """
        with self._commit:
            with self._ticket_lock:
                group = []
                for t in self._spill_queue:
                    if t.state != "spilled":
                        break
                    group.append(t)
            if not group:
                return
            snap = self._snapshot
            if group[0].delta.base != snap.num_series:
                raise RuntimeError(
                    "ticket offsets out of sync with the committed snapshot")
            new_snap = dataclasses.replace(
                snap,
                deltas=snap.deltas + tuple(t.delta for t in group),
                version=snap.version + 1)
            try:
                durable.write_manifest(
                    self.workdir, self._manifest_for(new_snap),
                    self._fault)
            except BaseException as e:
                self._poison_from(group[0], e)
                raise
            with self._mutate:
                self._snapshot = new_snap
                for t in group:
                    self._count_append(t.delta, t.t0)
                self._stats["group_commits"] += 1
            with self._ticket_lock:
                del self._spill_queue[: len(group)]
                for t in group:
                    t.state = "committed"
                    t.event.set()

    def _publish_append(self, snap: Snapshot, delta: DeltaShard,
                        t0: float) -> None:
        self._snapshot = dataclasses.replace(
            snap, deltas=snap.deltas + (delta,), version=snap.version + 1)
        self._count_append(delta, t0)

    def _count_append(self, delta: DeltaShard, t0: float) -> None:
        s = self._stats
        s["appends"] += 1
        s["appended_series"] += delta.num_series
        s["convert_time"] += time.perf_counter() - t0

    def compact(
        self,
        tier: str = "full",
        on_before_publish: Optional[Callable[[], None]] = None,
        demote: bool = False,
    ) -> Optional[CompactionResult]:
        """Fold one tier; linear merges only, bounded by the tier's size.

        ``tier="minor"`` folds the current delta shards into ONE run (the
        base is never touched); ``tier="major"`` folds the base + the
        accumulated runs into a new base (deltas untouched);
        ``tier="full"`` folds everything.

        Grabs one snapshot, merges its runs in ascending offset order on
        the device (:func:`merge_runs` breaks key ties toward the earlier
        run, i.e. the lower file position, reproducing the stable
        leaf-order sort), and publishes a snapshot that keeps every
        component appended *during* the merge. Queries in flight keep
        their old snapshot, whose tensors nothing writes. On a durable
        store the merged component spills and the manifest commits before
        the swap, and the retired components' dirs are GC'd only after.
        Returns None when the tier has nothing to fold.

        ``demote=True`` (major/full, durable stores only) sends the
        merged component to the COLD tier instead of a new in-memory
        base (``core.coldtier``). A demotion may fold a lone base.

        ``on_before_publish`` is a test hook that runs after the merge but
        before the swap — the window where "mid-compaction" is observable.
        """
        if tier not in ("minor", "major", "full"):
            raise ValueError(f"unknown compaction tier {tier!r}")
        if demote:
            if tier == "minor":
                raise ValueError("demotion folds the base: use tier="
                                 "'major' or 'full'")
            if not self.durable:
                raise ValueError(
                    "demotion requires a durable store (workdir): the "
                    "cold tier reads raw series from disk")
        with self._compact:
            snap = self._snapshot
            fold_runs = snap.runs if tier in ("major", "full") else ()
            fold_deltas = snap.deltas if tier in ("minor", "full") else ()
            with_base = tier in ("major", "full")
            if not fold_runs and not fold_deltas and not (
                    demote and snap.base.num_series):
                return None
            t0 = time.perf_counter()
            parts = []
            if with_base and snap.base.num_series:
                parts.append((snap.base_keys,
                              [snap.base.sax,
                               snap.base.pos + snap.base_offset]))
            shards = list(fold_runs) + list(fold_deltas)
            for s in shards:
                parts.append((s.keys, [s.index.sax, s.index.pos + s.base]))
            keys, (sax_sorted, pos_sorted) = merge_runs(parts)
            offset = snap.base_offset if with_base else shards[0].base
            raws = ([snap.base.raw] if with_base and snap.base.num_series
                    else []) + [s.index.raw for s in shards]
            raw = torch.cat(raws) if len(raws) > 1 else raws[0]
            merged = assemble_index(
                sax_sorted, pos_sorted - offset, raw,
                self.segments, self.cardinality)
            del parts, raws, raw, sax_sorted, pos_sorted
            cold_shard = None
            name = None
            if self.durable:
                with self._ticket_lock:
                    name = self._alloc_epoch()
                # Spill OUTSIDE the commit lock: the dir is an orphan
                # until a manifest (or, for a demotion, the catalog)
                # references it, so appends keep committing.
                if demote:
                    cold_shard = self._spill_cold(name, keys, merged,
                                                  offset)
                else:
                    self._spill_shard(name, keys, merged, offset)
            if merged.device.type == "cuda":
                torch.cuda.synchronize(merged.device)
            merge_time = time.perf_counter() - t0
            if on_before_publish is not None:
                on_before_publish()
            t1 = time.perf_counter()
            result, old_base_dir = self._publish_compaction(
                tier, snap, merged, keys, name, len(fold_deltas),
                fold_runs, fold_deltas, merge_time, t1, cold_shard)
            if self.durable:
                # GC after the commit made the retirees unreferenced; a
                # crash mid-GC leaves orphans the next recovery sweeps.
                gone = [old_base_dir] if old_base_dir else []
                gone += [s.dir for s in shards if s.dir]
                for d in gone:
                    durable._fire(self._fault, f"gc:{d}")
                    shutil.rmtree(os.path.join(self.workdir, d),
                                  ignore_errors=True)
            return result

    def _publish_compaction(
        self, tier, snap, merged, keys, name, n_deltas_folded,
        fold_runs, fold_deltas, merge_time, t1, cold_shard=None,
    ) -> tuple:
        """Swap in the post-fold snapshot (and commit it, when durable).

        Deltas only ever append at the tail and only compaction
        (serialized by ``_compact``) replaces runs or the base, so the
        first ``n_deltas_folded`` deltas of the *current* snapshot are
        exactly the ones merged; everything after arrived during the
        merge and survives. A demotion (``cold_shard``) publishes an EMPTY
        base directly above the new cold epoch.
        """
        old_base_dir = None
        locks = [self._commit] if self.durable else []
        for lk in locks:
            lk.acquire()
        try:
            with self._mutate:
                cur = self._snapshot
                if tier == "minor":
                    new_run = DeltaShard(index=merged, keys=keys,
                                         base=fold_deltas[0].base, dir=name)
                    new_snap = Snapshot(
                        snap.base, snap.base_keys,
                        cur.runs + (new_run,),
                        cur.deltas[n_deltas_folded:], cur.version + 1,
                        cold=cur.cold, base_offset=cur.base_offset)
                    new_base = None
                elif cold_shard is not None:
                    new_run = None
                    new_base = empty_index(
                        self.series_length, self.segments,
                        self.cardinality, device=self.device)
                    new_snap = Snapshot(
                        new_base,
                        torch.zeros((0,), dtype=torch.int64,
                                    device=self.device), (),
                        cur.deltas[n_deltas_folded:], cur.version + 1,
                        cold=cur.cold + (cold_shard,),
                        base_offset=cold_shard.base
                        + cold_shard.num_series)
                else:
                    new_run = None
                    new_base = merged
                    new_snap = Snapshot(
                        merged, keys, (),
                        cur.deltas[n_deltas_folded:], cur.version + 1,
                        cold=cur.cold, base_offset=cur.base_offset)
                if self.durable:
                    if tier != "minor":
                        old_base_dir = (
                            self._base_ref.dir if self._base_ref else None)
                        if cold_shard is not None:
                            self._base_ref = None
                        else:
                            self._base_ref = (durable.ComponentRef(
                                name, new_snap.base_offset,
                                merged.num_series)
                                if merged.num_series else None)
                    durable.write_manifest(
                        self.workdir, self._manifest_for(new_snap),
                        self._fault)
                self._snapshot = new_snap
                stall = time.perf_counter() - t1
                s = self._stats
                s["compactions"] += 1
                s["compacted_series"] += int(
                    sum(x.num_series for x in fold_runs + fold_deltas))
                if cold_shard is not None:
                    s["demotions"] += 1
                    s["demoted_series"] += cold_shard.num_series
                s["merge_time"] += merge_time
                s["stall_time_max"] = max(s["stall_time_max"], stall)
        finally:
            for lk in locks:
                lk.release()
        return CompactionResult(
            tier=tier, base=new_base, run=new_run,
            retired_runs=fold_runs, retired_deltas=fold_deltas,
            snapshot=new_snap, merge_time=merge_time, stall_time=stall,
            cold=cold_shard,
        ), old_base_dir

    def maybe_compact(
        self, policy: CompactionPolicy
    ) -> Optional[CompactionResult]:
        """Run the fold ``policy`` says is due (if any)."""
        tier = policy.plan(self._snapshot)
        if tier is None:
            return None
        return self.compact(
            tier=tier,
            demote=(policy.demote_major and self.durable
                    and tier in ("major", "full")))

    def demote(self) -> Optional[CompactionResult]:
        """Fold base + runs and push the result to the cold tier.

        ``compact(tier="major", demote=True)``: afterwards the store's
        oldest tier costs no raw-series device memory — queries read raw
        rows on demand through the block cache, bit-exact. Returns None
        only when there is nothing to demote.
        """
        return self.compact(tier="major", demote=True)

    # ------------------------------------------------------------- search
    def _packed_view(self, snap: Snapshot) -> PackedComponents:
        """The snapshot's fused view, refreshed incrementally.

        Cached on the (immutable) snapshot object; the packer's mutable
        state is serialized by ``_pack``, and a query racing on an older
        snapshot gets a scratch pack rather than regressing the shared
        buffers.
        """
        with trace.span("paris.live.pack"):
            packed = getattr(snap, "_packed", None)
            if packed is not None:
                return packed
            t0 = time.perf_counter()
            with self._pack:
                packed = getattr(snap, "_packed", None)
                if packed is not None:  # lost the race; already built
                    return packed
                packed, rows = self._packer.update(snap)
                object.__setattr__(snap, "_packed", packed)
            dt = time.perf_counter() - t0
            with self._mutate:
                s = self._stats
                s["pack_builds"] += 1
                s["pack_time"] += dt
                s["pack_time_max"] = max(s["pack_time_max"], dt)
                s["pack_rows_repacked"] += int(rows)
            return packed

    @staticmethod
    def _use_fused(fused, comps: list, sort: bool,
                   has_cold: bool = False) -> bool:
        if not isinstance(fused, bool) and fused != "auto":
            raise ValueError(f"fused must be bool or 'auto', got {fused!r}")
        if has_cold:
            # The reference's packed buffers sit in host memory, where the
            # cold raw would defeat the tier; the port keeps its refusal:
            # cold snapshots always answer per-component + merge.
            if fused is True:
                raise ValueError(
                    "fused search is unavailable over a cold tier: the "
                    "packed view would materialize the on-disk raw")
            return False
        if not sort:  # the ADS+-style serial scan has no packed variant
            return False
        if isinstance(fused, bool):
            return fused
        return len(comps) >= 2

    def _count_call(self, path: str) -> None:
        """One more search call down ``path`` (a counter of ``_stats``)."""
        with self._count:
            self._stats[path] += 1

    def _empty_answer(self, nq: int, k: int) -> tuple:
        return (torch.full((nq, k), INF, device=self.device),
                torch.full((nq, k), NO_POS, dtype=torch.int32,
                           device=self.device))

    def _merged(self, ds: list, ps: list, k: int) -> tuple:
        """Per-component top lists -> the global top-k, on the device."""
        d, p = merge_top_lists(ds, ps, k)
        return (torch.from_numpy(d).to(self.device),
                torch.from_numpy(p).to(self.device))

    def exact_knn_batch(
        self, queries, k: int = 1, fused="auto", **kw
    ) -> tuple:
        """Exact k-NN over the live view: (Q, n) -> ((Q, k) d, (Q, k) pos).

        ``fused=True`` (or ``"auto"`` with 2+ live components) answers
        from ONE fused multi-component pass over the snapshot's packed
        view; positions come back global. The per-component path
        (``fused=False``, a lone component, or any cold tier) runs one
        engine per component (cold shards first: they own the lowest
        offsets, and the merge breaks distance ties toward the earlier
        list) and merges with
        :func:`~repro_torch.core.search.merge_top_lists`. Both are exact
        against a from-scratch build over the concatenated data. Tensors
        on the store's device.
        """
        with trace.span("paris.live"):
            snap = self._snapshot
            qs = as_f32(queries, self.device)
            comps = snap.components()
            if not comps and not snap.cold:
                return self._empty_answer(qs.shape[0], k)
            if self._use_fused(fused, comps, kw.get("sort", True),
                               bool(snap.cold)):
                # Same kwarg surface as core.exact_knn_batch: an unknown
                # key must fail here exactly like the per-component path
                # would.
                unknown = set(kw) - {"round_size", "impl", "select",
                                     "sort", "leaf_cap", "stats"}
                if unknown:
                    raise TypeError(
                        f"unexpected keyword arguments: {sorted(unknown)}")
                packed = self._packed_view(snap)
                self._count_call("fused_calls")
                out = search._engine_call(
                    packed, search._packed_view(packed), qs, k=k,
                    round_size=kw.get("round_size", 4096),
                    select=kw.get("select", "topk"),
                    impl=kw.get("impl", "auto"))
                return out if kw.get("stats", False) else out[:2]
            self._count_call("component_calls")
            with trace.span("paris.live.merge"):
                ds, ps = [], []
                for shard in snap.cold:
                    d, p = coldtier.cold_exact_knn_batch(shard, qs, k=k,
                                                         **kw)
                    ds.append(d)
                    ps.append(torch.where(p >= 0, p + shard.base, NO_POS))
                for index, off in comps:
                    d, p = exact_knn_batch(index, qs, k=k, **kw)
                    ds.append(d)
                    ps.append(torch.where(p >= 0, p + off, NO_POS))
                return self._merged(ds, ps, k)

    def knn_batch_tiered(
        self, queries, tier, k: int = 1, fused="auto",
        round_size: int = 4096, select: str = "topk", impl: str = "auto",
    ) -> tuple:
        """Tiered k-NN over the live view (see ``search.Tier``).

        (Q, n) -> ((Q, k) d, (Q, k) pos, (Q,) numpy achieved epsilon).
        The fused path seeds the packed engine's BSF from the largest live
        component's bucket table (:func:`~repro_torch.core.search.
        packed_seed`); the exact fused path stays unseeded. The
        per-component path answers each component at the request tier and
        merges; the combined achieved bound is the per-query MAX over
        components.
        """
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        qs = as_f32(queries, self.device)
        nq = qs.shape[0]
        tiers = _tier_list(tier, nq)
        snap = self._snapshot
        comps = snap.components()
        if not comps and not snap.cold:  # empty store: certified exact
            return (*self._empty_answer(nq, k), np.zeros((nq,), np.float64))
        if all(t.kind == "exact" for t in tiers):
            d, p = self.exact_knn_batch(
                qs, k=k, fused=fused, round_size=round_size,
                select=select, impl=impl)
            return d, p, np.zeros((nq,), np.float64)
        with trace.span("paris.live"):  # the exact tier has its own
            if self._use_fused(fused, comps, True, bool(snap.cold)):
                packed = self._packed_view(snap)
                self._count_call("fused_calls")
                top_d, top_p, *_, eps = search._engine_call(
                    packed, search._packed_view(packed), qs, k=k,
                    round_size=round_size, select=select, impl=impl,
                    tier=tiers, seed=packed_seed(comps, qs))
                return top_d, top_p, eps
            self._count_call("component_calls")
            with trace.span("paris.live.merge"):
                ds, ps = [], []
                ach = np.zeros((nq,), np.float64)
                for shard in snap.cold:  # lowest offsets first (ties)
                    d, p, a = coldtier.cold_knn_batch_tiered(
                        shard, qs, tiers, k=k, round_size=round_size,
                        select=select, impl=impl)
                    ds.append(d)
                    ps.append(torch.where(p >= 0, p + shard.base, NO_POS))
                    ach = np.maximum(ach, a)
                for index, off in comps:
                    d, p, a = knn_batch_tiered(
                        index, qs, tiers, k=k, round_size=round_size,
                        select=select, impl=impl)
                    ds.append(d)
                    ps.append(torch.where(p >= 0, p + off, NO_POS))
                    ach = np.maximum(ach, a)
                d, p = self._merged(ds, ps, k)
                return d, p, ach

    def exact_search_batch(
        self, queries, cfg: SearchConfig = SearchConfig(), fused="auto"
    ) -> SearchResult:
        """Exact 1-NN over the live view: (Q, n) -> SearchResult of (Q,).

        Fused single-sweep by default with 2+ components; otherwise
        per-component engines + the router's 1-NN reduction: min by
        (distance, global position), raw reads and BSF updates summed,
        rounds maxed.
        """
        snap = self._snapshot
        qs = as_f32(queries, self.device)
        comps = snap.components()
        nq = qs.shape[0]
        dev = self.device
        if not comps and not snap.cold:
            z = torch.zeros((nq,), dtype=torch.int32, device=dev)
            d, p = self._empty_answer(nq, 1)
            return SearchResult(d[:, 0], p[:, 0], z, z, 0)
        if self._use_fused(fused, comps, cfg.sort, bool(snap.cold)):
            packed = self._packed_view(snap)
            self._count_call("fused_calls")
            top_d, top_p, *rest = search._engine_call(
                packed, search._packed_view(packed), qs, k=1,
                round_size=cfg.round_size, select=cfg.select, impl=cfg.impl)
            return SearchResult(top_d[:, 0], top_p[:, 0], *rest)
        self._count_call("component_calls")
        pairs = [(shard.base,
                  coldtier.cold_exact_search_batch(shard, qs, cfg))
                 for shard in snap.cold]
        pairs += [(off, exact_search_batch(index, qs, cfg))
                  for index, off in comps]
        best_d = torch.full((nq,), INF, device=dev)
        best_p = torch.full((nq,), NO_POS, dtype=torch.int64, device=dev)
        for off, r in pairs:
            d = r.dist_sq
            p = r.position.to(torch.int64) + off
            better = (d < best_d) | ((d == best_d) & (p < best_p))
            best_d = torch.where(better, d, best_d)
            best_p = torch.where(better, p, best_p)
        parts = [r for _, r in pairs]
        return SearchResult(
            best_d,
            best_p.to(torch.int32),
            torch.stack([r.raw_reads for r in parts]).sum(dim=0),
            torch.stack([r.bsf_updates for r in parts]).sum(dim=0),
            max(int(r.rounds) for r in parts),
        )

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Counter snapshot: appends, compactions, spills, component counts.

        ``live_components`` counts the snapshot's non-empty in-memory
        components; ``packed_rows`` is the row count (N_pad, dead capacity
        and block pads included) of the snapshot's packed view, 0 where
        no search has built one.
        """
        with self._mutate, self._count:
            s = dict(self._stats)
        snap = self._snapshot
        packed = getattr(snap, "_packed", None)
        s.update(
            live_components=sum(1 for ix, _ in snap.components()
                                if ix.num_series),
            packed_rows=0 if packed is None else int(packed.sax.shape[0]),
            num_series=snap.num_series,
            num_deltas=len(snap.deltas),
            num_runs=len(snap.runs),
            num_cold=len(snap.cold),
            cold_series=sum(c.num_series for c in snap.cold),
            base_series=snap.base.num_series,
            version=snap.version,
            durable=self.durable,
            spill_queue_depth=len(self._spill_queue),
            cold_cache=self._cold_cache.stats(),
        )
        return s


@dataclasses.dataclass
class IngestStats:
    """Aggregate append-side throughput counters."""
    batches: int = 0
    series: int = 0
    total_time: float = 0.0

    @property
    def series_per_sec(self) -> float:
        """Appended series per second of total append time."""
        return self.series / max(self.total_time, 1e-9)


class IngestPipeline:
    """Streaming front of the mutable index: batches in, delta shards out.

    Callers hand it (B, n) batches (host arrays or tensors on the store's
    device); ``chunk_series`` optionally re-chunks big appends so each
    delta shard stays epoch-shard-sized. Tracks insert throughput.
    """

    def __init__(
        self, index: MutableIndex, *, chunk_series: Optional[int] = None
    ):
        if chunk_series is not None and chunk_series < 1:
            raise ValueError("chunk_series must be >= 1")
        self.index = index
        self.chunk_series = chunk_series
        self.stats = IngestStats()

    def append(self, batch) -> List[DeltaShard]:
        """Ingest one batch (re-chunked if configured); returns its shards."""
        if not isinstance(batch, torch.Tensor):
            batch = np.asarray(batch, np.float32)
        t0 = time.perf_counter()
        step = self.chunk_series or max(len(batch), 1)
        shards = [
            self.index.append(batch[s: s + step])
            for s in range(0, len(batch), step)
        ]
        self.stats.batches += 1
        self.stats.series += len(batch)
        self.stats.total_time += time.perf_counter() - t0
        return shards

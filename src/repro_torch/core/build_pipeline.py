"""Staged, double-buffered index construction (paper §3.1–3.2, Figs. 3–5).

Counterpart of ``repro/core/build_pipeline.py``: the paper's three-stage
scheduling, with the summarization on the card.

  Stage 1 — Coordinator: reads raw-series chunks from the SeriesSource (the
    "disk") into one half of a double buffer while workers process the other
    half. Chunk size = the paper's double-buffer-size knob (Fig. 11).
  Stage 2 — IndexBulkLoading, on the builder's device: the chunk is copied
    there, z-normalized (``isax.znorm``) into the index's raw buffer,
    summarized by the ``paa_isax`` kernel (``normalize=False``), keyed, and
    — in ParIS+ mode — presorted into leaf order (a stable sort), which
    overlaps the Coordinator's next read. In ParIS mode the sort waits.
  Stage 3 — IndexConstruction: at every memory-limit epoch, turns the
    accumulated runs into leaf order (ParIS+: linear merges; ParIS: one
    stop-the-world sort) and writes them as an epoch shard on disk.

  Finalize — epoch shards are merge-sorted into the final index.

The packed refine key fills all 64 bits at the paper's widths (4 planes of
w = 16 bits; bit 63 is segment 0's root bit). PyTorch sorts and searches
int64 only, where every key with bit 63 set would come *first*; so the
port keeps each key as its uint64 bit pattern XOR ``1 << 63``, viewed as
int64 (a "sortable" key), whose signed order is the unsigned order of the
key. Every sort, ``searchsorted`` and merge runs on sortable keys; they
turn back into uint64 only where they meet the files (:func:`keys_to_u64`,
:func:`keys_from_u64`). Epoch shards (``e{N}/keys.npy`` uint64,
``sax.npy`` uint8, ``pos.npy`` int32) are byte for byte the reference's.

Per-stage wall-clock times are taken with the device synchronised at the
end of each stage, so no stage is charged for another's queued work. On
the card each Stage-2 worker thread launches on a CUDA stream of its own
and waits for that stream alone, so a worker's time holds none of another
worker's queued kernels or copies (concurrent kernels still share the
SMs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import isax
from repro_torch.core.datagen import SeriesSource
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.index import assemble_index, empty_index
from repro_torch.kernels import ops

# XOR with this flips bit 63: uint64 order becomes int64 order.
SIGN_BIT = -(1 << 63)


@dataclasses.dataclass
class BuildStats:
    """Per-stage wall-clock timings for one pipelined index build."""
    read_time: float = 0.0  # Stage 1: "disk" -> buffer
    convert_time: float = 0.0  # Stage 2: ConvertToSAX (+ ParIS+ presort)
    construct_time: float = 0.0  # Stage 3: sort/merge into leaf order
    flush_time: float = 0.0  # Stage 3: epoch shard writes
    finalize_time: float = 0.0  # final multi-epoch merge
    total_time: float = 0.0
    epochs: int = 0
    chunks: int = 0

    @property
    def cpu_time(self) -> float:
        """Total compute-stage time (convert + construct)."""
        return self.convert_time + self.construct_time

    @property
    def overlap_efficiency(self) -> float:
        """Fraction of compute hidden behind I/O (1.0 = fully hidden)."""
        busy = self.cpu_time
        if busy <= 0:
            return 1.0
        if self.total_time <= 0:
            # Mid-build (total_time not stamped yet): the exposed-time
            # estimate below would read as "fully hidden" — report zero
            # overlap instead of a spuriously perfect figure.
            return 0.0
        exposed = max(self.total_time - self.read_time - self.flush_time
                      - self.finalize_time, 0.0)
        return max(0.0, min(1.0, 1.0 - exposed / busy))


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (a stage boundary)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def refine_key(sax: torch.Tensor, refine_bits: int,
               cardinality: int) -> torch.Tensor:
    """Sortable packed bit-plane keys (int64) of (m, w) SAX rows.

    The reference's ``_host_refine_key``: plane 0 (the root key) in the
    top ``w`` bits, then the next planes; int64 shifts wrap as uint64 ones
    do. Returned with the sign bit flipped (see the module docstring).
    """
    w = sax.shape[-1]
    key = torch.zeros(sax.shape[:-1], dtype=torch.int64, device=sax.device)
    for plane in isax.refine_keys(sax, refine_bits, cardinality):
        key = (key << w) | plane
    return key ^ SIGN_BIT


def keys_to_u64(keys: torch.Tensor) -> np.ndarray:
    """Sortable int64 keys -> the uint64 keys the files hold (host)."""
    return (keys ^ SIGN_BIT).cpu().numpy().view(np.uint64)


def keys_from_u64(keys, device) -> torch.Tensor:
    """uint64 keys from a file -> sortable int64 keys on ``device``."""
    k = np.ascontiguousarray(keys, np.uint64).view(np.int64)
    return torch.from_numpy(k.copy()).to(device) ^ SIGN_BIT


def _merge_sorted(keys_a, keys_b, payloads_a, payloads_b):
    """Stable linear merge of two sorted runs (vectorized, no Python loop).

    Ties go to run A (``side="left"`` for A's rows, ``"right"`` for B's):
    with runs in file-offset order that is a stable sort of the input.
    """
    na, nb = keys_a.shape[0], keys_b.shape[0]
    dev = keys_a.device
    out_a = torch.arange(na, device=dev) + torch.searchsorted(
        keys_b, keys_a, side="left")
    out_b = torch.arange(nb, device=dev) + torch.searchsorted(
        keys_a, keys_b, side="right")
    keys = keys_a.new_empty(na + nb)
    keys[out_a] = keys_a
    keys[out_b] = keys_b
    merged = []
    for pa, pb in zip(payloads_a, payloads_b):
        buf = pa.new_empty((na + nb, *pa.shape[1:]))
        buf[out_a] = pa
        buf[out_b] = pb
        merged.append(buf)
    return keys, merged


def merge_runs(runs):
    """log2(k) pairwise-merge passes over (keys, [payloads...]) runs.

    Linear merges only — the ParIS+ property the epoch finalize and the
    live-ingest compactor (``core.ingest``) both rely on. Keys are
    sortable int64 tensors. Runs must be ordered by file offset:
    ``_merge_sorted`` breaks key ties toward the left run, so offset order
    makes ties resolve by original position — exactly a stable sort over
    the concatenated input.
    """
    if not runs:
        raise ValueError("merge_runs needs at least one run")
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            (ka, pa), (kb, pb) = runs[i], runs[i + 1]
            nxt.append(_merge_sorted(ka, kb, pa, pb))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def _to_device(chunk, device: torch.device) -> torch.Tensor:
    """A host chunk (copied) or a tensor already on ``device``, float32."""
    if isinstance(chunk, torch.Tensor):
        return as_f32(chunk, device)
    host = np.ascontiguousarray(chunk, np.float32)
    return torch.from_numpy(host).to(device)


def _stage2(chunk, offset: int, *, segments: int, cardinality: int,
            refine_bits: int, breakpoints: torch.Tensor, impl: str,
            presort: bool, device: torch.device) -> tuple:
    """Stage 2 on one chunk: (z-normed rows, keys, sax, pos) on ``device``.

    The z-normed rows stay in file order; keys, SAX and positions are in
    leaf order when ``presort``.
    """
    x = isax.znorm(_to_device(chunk, device))
    sax, _ = ops.paa_isax(x, breakpoints, segments, impl=impl,
                          normalize=False)
    keys = refine_key(sax, refine_bits, cardinality)
    pos = torch.arange(offset, offset + x.shape[0], dtype=torch.int32,
                       device=device)
    if presort:
        keys, order = torch.sort(keys, stable=True)
        sax, pos = sax[order], pos[order]
    return x, keys, sax, pos


def bulk_load_chunk(
    chunk,
    offset: int,
    *,
    segments: int,
    cardinality: int,
    refine_bits: int = 4,
    breakpoints=None,
    impl: str = "auto",
    presort: bool = True,
    device="cuda",
):
    """Stage-2 IndexBulkLoading on one chunk: (keys, sax, pos) on ``device``.

    The reusable core of the builder's ConvertToSAX task — znorm + the
    paa_isax kernel + sortable packed refine keys + (optionally) the
    ParIS+ presort into leaf order. ``offset`` is the chunk's global file
    position, baked into ``pos``. ``chunk`` is a host (B, n) array or a
    tensor on ``device``. Shared by :class:`PipelineBuilder` and the
    live-ingest delta-shard builder (``core.ingest.build_delta_shard``),
    so both paths produce byte-identical sorted runs.
    """
    dev = resolve_device(device)
    if breakpoints is None:
        breakpoints = isax.gaussian_breakpoints(cardinality, dev)
    _, keys, sax, pos = _stage2(
        chunk, offset, segments=segments, cardinality=cardinality,
        refine_bits=refine_bits, breakpoints=breakpoints, impl=impl,
        presort=presort, device=dev)
    return keys, sax, pos


def _save_shard(epoch_dir: str, keys, sax, pos) -> None:
    """One epoch shard in the reference's format (uint64, uint8, int32)."""
    os.makedirs(epoch_dir, exist_ok=True)
    np.save(os.path.join(epoch_dir, "keys.npy"), keys_to_u64(keys))
    np.save(os.path.join(epoch_dir, "sax.npy"), sax.cpu().numpy())
    np.save(os.path.join(epoch_dir, "pos.npy"),
            pos.to(torch.int32).cpu().numpy())


def _load_shard(epoch_dir: str, device) -> tuple:
    """(keys, [sax, pos]) of one epoch shard, on ``device``."""
    def load(name):
        return np.load(os.path.join(epoch_dir, name))

    return (keys_from_u64(load("keys.npy"), device),
            [torch.from_numpy(load("sax.npy")).to(device),
             torch.from_numpy(load("pos.npy")).to(device)])


class PipelineBuilder:
    """ParIS/ParIS+ index builder. ``mode``: "paris+", "paris", or "serial".

    Builds on ``device`` (the card unless the caller asks for the CPU).
    """

    def __init__(
        self,
        segments: int = isax.DEFAULT_SEGMENTS,
        cardinality: int = isax.DEFAULT_CARDINALITY,
        *,
        mode: str = "paris+",
        n_workers: int = 4,
        refine_bits: int = 4,
        mem_limit_series: Optional[int] = None,
        impl: str = "auto",
        workdir: Optional[str] = None,
        device="cuda",
    ):
        if mode not in ("paris+", "paris", "serial"):
            raise ValueError(f"unknown mode {mode!r}")
        self.segments = segments
        self.cardinality = cardinality
        self.mode = mode
        self.n_workers = max(0 if mode == "serial" else 1, n_workers)
        self.refine_bits = refine_bits
        self.mem_limit_series = mem_limit_series
        self.impl = impl
        self.workdir = workdir
        self.device = resolve_device(device)
        self._bp = isax.gaussian_breakpoints(cardinality, self.device)
        self._local = threading.local()  # each worker thread's stream

    def _stream(self):
        """The calling thread's own CUDA stream, made on its first call."""
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.device)
        return stream

    # -- Stage 2 task: ConvertToSAX (+ presort in ParIS+ mode) ------------
    def _bulk_load(self, chunk: np.ndarray, offset: int, raw: torch.Tensor):
        t0 = time.perf_counter()
        stream = self._stream() if self.device.type == "cuda" else None
        if stream is not None:
            # The breakpoints and the raw buffer came from the default
            # stream; everything after this runs on the worker's own.
            stream.wait_stream(torch.cuda.default_stream(self.device))
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            # In ParIS+ mode the incremental "tree building" (presort into
            # leaf order) happens here, overlapped with the Coordinator's
            # next read.
            x, keys, sax, pos = _stage2(
                chunk, offset, segments=self.segments,
                cardinality=self.cardinality, refine_bits=self.refine_bits,
                breakpoints=self._bp, impl=self.impl,
                presort=self.mode == "paris+", device=self.device)
            raw[offset:offset + x.shape[0]] = x  # the index's file-order raw
        if stream is not None:
            stream.synchronize()  # this worker's work only
            for t in (keys, sax, pos):  # read next on the default stream
                t.record_stream(torch.cuda.default_stream(self.device))
        dt = time.perf_counter() - t0
        return offset, keys, sax, pos, dt

    # -- Stage 3: epoch construction + shard flush -------------------------
    def _construct_epoch(self, runs, epoch_dir: str, stats: BuildStats):
        t0 = time.perf_counter()
        # Runs are keyed by file offset so that equal-key ties always break
        # by original position — the pipeline is byte-identical to the
        # one-shot build_index() regardless of worker completion order.
        runs = [r[1:] for r in sorted(runs, key=lambda r: r[0])]
        if self.mode == "paris+":
            keys, (sax, pos) = merge_runs(runs)  # linear merges only
        else:
            keys = torch.cat([r[0] for r in runs])
            sax = torch.cat([r[1][0] for r in runs])
            pos = torch.cat([r[1][1] for r in runs])
            keys, order = torch.sort(keys, stable=True)  # stop-the-world
            sax, pos = sax[order], pos[order]
        _sync(self.device)
        stats.construct_time += time.perf_counter() - t0
        t0 = time.perf_counter()
        _save_shard(epoch_dir, keys, sax, pos)
        stats.flush_time += time.perf_counter() - t0
        stats.epochs += 1

    def build(self, source: SeriesSource):
        """Run the pipeline; returns (ParISIndex, BuildStats).

        An empty source produces an empty (zero-series) index. On failure
        with a caller-owned ``workdir``, every epoch shard directory this
        run created is removed — a later build into the same workdir never
        sees partial ``e{N}`` shards.
        """
        stats = BuildStats()
        t_start = time.perf_counter()
        workdir = self.workdir or tempfile.mkdtemp(prefix="paris_build_")
        own_workdir = self.workdir is None
        epoch_runs: List = []
        epoch_dirs: List[str] = []
        series_in_mem = 0
        mem_limit = self.mem_limit_series or (1 << 62)
        ok = False
        # Stage 2 z-normalizes each chunk straight into the index's raw
        # buffer, so the file is read once.
        raw = torch.empty((source.num_series, source.length),
                          dtype=torch.float32, device=self.device)

        def take(fut: Future) -> None:
            # Results are collected by this thread as it waits on each
            # future, never by a done-callback: a callback may run after
            # ``result()`` has returned, and its run could then miss the
            # epoch being flushed.
            offset, keys, sax, pos, dt = fut.result()
            epoch_runs.append((offset, keys, [sax, pos]))
            stats.convert_time += dt

        def flush_epoch():
            nonlocal epoch_runs
            runs, epoch_runs = epoch_runs, []
            # Record the shard dir BEFORE writing so a mid-write failure
            # still cleans it up (caller-owned workdir, see finally).
            d = os.path.join(workdir, f"e{len(epoch_dirs)}")
            epoch_dirs.append(d)
            self._construct_epoch(runs, d, stats)

        try:
            if self.mode == "serial":
                for i in range(source.num_chunks):
                    t0 = time.perf_counter()
                    chunk, off = source.read(i)
                    stats.read_time += time.perf_counter() - t0
                    offset, keys, sax, pos, dt = self._bulk_load(
                        chunk, off, raw)
                    epoch_runs.append((offset, keys, [sax, pos]))
                    stats.convert_time += dt
                    stats.chunks += 1
                    series_in_mem += len(chunk)
                    if series_in_mem >= mem_limit:
                        flush_epoch()
                        series_in_mem = 0
            else:
                with ThreadPoolExecutor(self.n_workers) as pool:
                    pending: List[Future] = []
                    for i in range(source.num_chunks):
                        t0 = time.perf_counter()
                        chunk, off = source.read(i)  # Coordinator fills B1
                        stats.read_time += time.perf_counter() - t0
                        # Double buffering: at most 2 chunks in flight — wait
                        # for the older half before reusing it.
                        while len(pending) >= 2:
                            take(pending.pop(0))
                        pending.append(
                            pool.submit(self._bulk_load, chunk, off, raw))
                        stats.chunks += 1
                        series_in_mem += len(chunk)
                        if series_in_mem >= mem_limit:
                            while pending:  # barrier (Alg. 4 line 9)
                                take(pending.pop(0))
                            flush_epoch()
                            series_in_mem = 0
                    while pending:
                        take(pending.pop(0))
            if epoch_runs:
                flush_epoch()

            if not epoch_dirs:
                # Empty source: no chunks were read, no epochs flushed.
                index = empty_index(source.length, self.segments,
                                    self.cardinality, device=self.device)
                stats.total_time = time.perf_counter() - t_start
                ok = True
                return index, stats

            # Finalize: merge epoch shards into the CSR index.
            t0 = time.perf_counter()
            shards = [_load_shard(d, self.device) for d in epoch_dirs]
            keys, (sax_sorted, pos_sorted) = merge_runs(shards)
            del keys
            index = assemble_index(sax_sorted, pos_sorted, raw,
                                   self.segments, self.cardinality)
            _sync(self.device)
            stats.finalize_time = time.perf_counter() - t0
            stats.total_time = time.perf_counter() - t_start
            ok = True
            return index, stats
        finally:
            if own_workdir:
                shutil.rmtree(workdir, ignore_errors=True)
            elif not ok:
                # Caller-owned workdir + a failed run: remove the epoch
                # shards this run created (partial or complete) so the
                # directory is not left littered with unusable e{N} dirs.
                for d in epoch_dirs:
                    shutil.rmtree(d, ignore_errors=True)

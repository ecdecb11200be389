"""LRU block cache over on-disk raw-series files (the cold tier's RAM).

A copy of ``repro/core/block_cache.py`` (numpy only, host memory), with
two changes: :meth:`ColdReader.rows` groups its rows another way, with
the same reads, and the counters also hold the seconds spent reading
blocks (``read_time``) and in row gathers (``gathers``, ``gather_time``).
The cold tier's rows are read here, then staged to the card.

The cold tier (``core.coldtier``) keeps SAX summaries and the bucket
table hot but leaves raw series on disk in the ``e{N}`` epoch format.
Every raw access routes through here: the file is carved into fixed
``block_rows``-row blocks, a query materializes only the blocks its
candidate rows land in, and recently used blocks stay pinned in an LRU
map under a configurable byte budget. ``bytes_read`` counts bytes
actually pulled from disk (cache misses), so bytes read per query
against the full-scan baseline is a machine-independent measure of
how much of the store a query touches.

Budget semantics:

  * ``budget_bytes=None`` — unlimited: every block read once stays
    resident (the all-in-RAM upper bound).
  * ``budget_bytes=0``    — store nothing: every access re-reads its
    block from disk (the no-cache lower bound).
  * otherwise             — LRU eviction keeps ``cached_bytes`` at or
    under the budget.

Answers are budget-independent by construction — the cache only decides
whether a block is re-READ, never what it contains — which is what the
cache-eviction parity test (identical answers at budgets {0, tiny,
unlimited}) pins down.

Thread safety: one lock guards the map and the counters. Loads happen
under the lock (two threads racing the same block would otherwise both
pay the read and double-count it); blocks are immutable once loaded, so
returned arrays are safe to read concurrently.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np


class BlockCache:
    """LRU map of ``(file id, block number) -> materialized row block``."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 block_rows: int = 64):
        if budget_bytes is not None and budget_bytes < 0:
            raise ValueError(
                f"budget_bytes must be None (unlimited) or >= 0, got "
                f"{budget_bytes}")
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        self.budget_bytes = budget_bytes
        self.block_rows = block_rows
        self._lock = threading.Lock()
        self._blocks: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._cached_bytes = 0
        self._hits = 0
        self._misses = 0
        self._bytes_read = 0
        self._evictions = 0
        self._read_time = 0.0
        self._gathers = 0
        self._gather_time = 0.0

    def get(self, key: tuple, loader: Callable[[], np.ndarray]) -> np.ndarray:
        """The block at ``key``, loading (and charging) it on a miss."""
        with self._lock:
            block = self._blocks.get(key)
            if block is not None:
                self._hits += 1
                self._blocks.move_to_end(key)
                return block
            t0 = time.perf_counter()
            block = loader()
            self._read_time += time.perf_counter() - t0
            self._misses += 1
            self._bytes_read += block.nbytes
            if self.budget_bytes == 0:
                return block  # store nothing: pure pass-through
            self._blocks[key] = block
            self._cached_bytes += block.nbytes
            if self.budget_bytes is not None:
                while (self._cached_bytes > self.budget_bytes
                       and self._blocks):
                    _, old = self._blocks.popitem(last=False)
                    self._cached_bytes -= old.nbytes
                    self._evictions += 1
            return block

    def charge_gather(self, seconds: float) -> None:
        """Count one row gather (:meth:`ColdReader.rows`) of ``seconds``."""
        with self._lock:
            self._gathers += 1
            self._gather_time += seconds

    def invalidate(self, file_id) -> None:
        """Drop every cached block of one file (a GC'd cold epoch)."""
        with self._lock:
            for key in [k for k in self._blocks if k[0] == file_id]:
                self._cached_bytes -= self._blocks.pop(key).nbytes

    def clear(self) -> None:
        """Drop everything (counters are kept — they are cumulative)."""
        with self._lock:
            self._blocks.clear()
            self._cached_bytes = 0

    def stats(self) -> dict:
        """Cumulative hit/miss/bytes-read counters and times (seconds in
        block reads, in row gathers) + current residency."""
        with self._lock:
            return dict(
                hits=self._hits, misses=self._misses,
                bytes_read=self._bytes_read, evictions=self._evictions,
                read_time=self._read_time, gathers=self._gathers,
                gather_time=self._gather_time,
                cached_bytes=self._cached_bytes,
                cached_blocks=len(self._blocks),
                budget_bytes=self.budget_bytes,
                block_rows=self.block_rows,
            )


class ColdReader:
    """Lazy row reader over one on-disk ``(m, n) float32`` ``.npy`` file.

    Backed by ``np.memmap`` (opened on first use, so constructing a
    reader touches nothing) and fronted by a shared :class:`BlockCache`.
    ``rows`` materializes exactly the blocks the requested row ids land
    in — the cold tier's "touch only the ranges the surviving buckets
    name" contract; everything else stays on disk.
    """

    def __init__(self, path: str, cache: BlockCache):
        self.path = path
        self.cache = cache
        self._mm: Optional[np.ndarray] = None
        self._mm_lock = threading.Lock()

    def _mmap(self) -> np.ndarray:
        mm = self._mm
        if mm is None:
            with self._mm_lock:
                mm = self._mm
                if mm is None:
                    mm = np.load(self.path, mmap_mode="r")
                    self._mm = mm
        return mm

    @property
    def shape(self) -> tuple:
        """(rows, row length) of the underlying file."""
        return self._mmap().shape

    @property
    def total_bytes(self) -> int:
        """Raw payload bytes on disk (the full-scan baseline)."""
        mm = self._mmap()
        return int(mm.shape[0]) * int(mm.shape[1]) * mm.dtype.itemsize

    def _load_block(self, b: int) -> np.ndarray:
        mm = self._mmap()
        br = self.cache.block_rows
        return np.array(mm[b * br: (b + 1) * br], dtype=np.float32)

    def rows(self, row_ids: np.ndarray) -> np.ndarray:
        """Gather rows by id through the cache: (r,) ids -> (r, n) f32.

        Each block is fetched once per call, in ascending block order, as
        in the reference; the rows are grouped by one stable sort instead
        of a mask per block, so a call costs O(r log r), not O(r x blocks)
        (a round at the paper's size touches tens of thousands of blocks).
        """
        t0 = time.perf_counter()
        row_ids = np.asarray(row_ids).ravel()
        mm = self._mmap()
        br = self.cache.block_rows
        out = np.empty((row_ids.size, mm.shape[1]), np.float32)
        blocks = row_ids // br
        order = np.argsort(blocks, kind="stable")
        uniq, starts = np.unique(blocks[order], return_index=True)
        ends = np.append(starts[1:], order.size)
        for b, s, e in zip(uniq.tolist(), starts.tolist(), ends.tolist()):
            block = self.cache.get(
                (self.path, b), lambda b=b: self._load_block(b))
            sel = order[s:e]
            out[sel] = block[row_ids[sel] - b * br]
        self.cache.charge_gather(time.perf_counter() - t0)
        return out

"""The ParIS index as a flat, radix-bucketed CSR structure of torch tensors.

Counterpart of ``repro/core/index.py``, with the same four arrays:

  * ``sax``            (N, w) uint8 — summarizations in leaf order
                       (root key, then refined bit-plane keys),
  * ``pos``            (N,) int32 — file position of each sorted entry,
  * ``bucket_offsets`` (2**w + 1,) int32 — CSR offsets of each root bucket,
  * ``raw``            (N, n) f32 — the z-normalized series in file order.

All four live on one device, the one ``build_index`` was given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import isax
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.kernels import ops

# Rows z-normalized per step in build_index: bounds the temporaries of the
# z-norm to a few GiB when N reaches the tens of millions.
ZNORM_CHUNK_ROWS = 1 << 20


@dataclasses.dataclass(frozen=True)
class ParISIndex:
    """Immutable iSAX index: sorted SAX words + root bucket table + raw data."""
    sax: torch.Tensor  # (N, w) uint8, index (sorted) order
    pos: torch.Tensor  # (N,) int32, index order -> file order
    bucket_offsets: torch.Tensor  # (2**w + 1,) int32
    raw: torch.Tensor  # (N, n) f32, file order (the "raw data file")
    series_length: int
    segments: int
    cardinality: int

    @property
    def num_series(self) -> int:
        """Number of indexed series."""
        return self.sax.shape[0]

    @property
    def num_buckets(self) -> int:
        """Number of root buckets."""
        return self.bucket_offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        """The device every array of the index lives on."""
        return self.sax.device

    def bucket(self, key) -> tuple:
        """(start, end) of a root bucket in index order."""
        return self.bucket_offsets[key], self.bucket_offsets[key + 1]


def sort_by_index_key(sax: torch.Tensor, cardinality: int,
                      refine_bits: int = 4) -> torch.Tensor:
    """Permutation (int64) sorting series into index (leaf) order.

    LSD: a stable argsort per bit plane, least significant plane first, so
    the most significant plane (the root key) dominates.
    """
    keys = isax.refine_keys(sax, refine_bits, cardinality)
    order = torch.arange(sax.shape[0], dtype=torch.int64, device=sax.device)
    for key in reversed(keys):
        order = order[torch.argsort(key[order], stable=True)]
    return order


def bucket_offsets_from_keys(sorted_root_keys: torch.Tensor,
                             num_buckets: int) -> torch.Tensor:
    """CSR offsets from the sorted root keys (vectorized searchsorted)."""
    targets = torch.arange(num_buckets + 1, dtype=sorted_root_keys.dtype,
                           device=sorted_root_keys.device)
    return torch.searchsorted(
        sorted_root_keys.contiguous(), targets, side="left").to(torch.int32)


def _znorm_rows(raw: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(raw)
    for s in range(0, raw.shape[0], ZNORM_CHUNK_ROWS):
        out[s:s + ZNORM_CHUNK_ROWS] = isax.znorm(raw[s:s + ZNORM_CHUNK_ROWS])
    return out


def _assemble(sax_sorted, pos_sorted, raw, segments, cardinality):
    root_sorted = isax.root_key(sax_sorted, cardinality)
    return ParISIndex(
        sax=sax_sorted.contiguous(),
        pos=pos_sorted.to(torch.int32),
        bucket_offsets=bucket_offsets_from_keys(root_sorted, 2 ** segments),
        raw=raw,
        series_length=raw.shape[-1],
        segments=segments,
        cardinality=cardinality,
    )


def build_index(
    raw,
    segments: int = isax.DEFAULT_SEGMENTS,
    cardinality: int = isax.DEFAULT_CARDINALITY,
    *,
    normalize: bool = True,
    refine_bits: int = 4,
    impl: str = "auto",
    device="cuda",
) -> ParISIndex:
    """One-shot in-memory index build on ``device``.

    ``raw`` is a (N, n) array (numpy, or a tensor already on ``device``).
    As in the reference, the series are z-normalized with ``isax.znorm``
    first (into a new tensor, ``ZNORM_CHUNK_ROWS`` rows at a time; the
    caller's data is not modified) and the ``paa_isax`` kernel then runs
    with ``normalize=False``.
    """
    dev = resolve_device(device)
    raw = as_f32(raw, dev).contiguous()
    if normalize:
        raw = _znorm_rows(raw)
    bp = isax.gaussian_breakpoints(cardinality, dev)
    sax, _ = ops.paa_isax(raw, bp, segments, impl=impl, normalize=False)
    order = sort_by_index_key(sax, cardinality, refine_bits)
    return _assemble(sax[order], order, raw, segments, cardinality)


def assemble_index(
    sax_sorted,
    pos_sorted,
    raw: torch.Tensor,
    segments: int,
    cardinality: int,
) -> ParISIndex:
    """Wrap pre-sorted arrays into an index on ``raw``'s device."""
    def on_device(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=raw.device, dtype=dtype)
        return torch.tensor(np.asarray(x), dtype=dtype, device=raw.device)

    return _assemble(on_device(sax_sorted, torch.uint8),
                     on_device(pos_sorted, torch.int32),
                     raw, segments, cardinality)


def empty_index(
    series_length: int,
    segments: int = isax.DEFAULT_SEGMENTS,
    cardinality: int = isax.DEFAULT_CARDINALITY,
    device="cuda",
) -> ParISIndex:
    """A structurally valid zero-series index (no engine can search it)."""
    dev = resolve_device(device)
    return ParISIndex(
        sax=torch.zeros((0, segments), dtype=torch.uint8, device=dev),
        pos=torch.zeros((0,), dtype=torch.int32, device=dev),
        bucket_offsets=torch.zeros((2 ** segments + 1,), dtype=torch.int32,
                                   device=dev),
        raw=torch.zeros((0, series_length), dtype=torch.float32, device=dev),
        series_length=series_length,
        segments=segments,
        cardinality=cardinality,
    )


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """S self-contained :class:`ParISIndex` shards over file-order slices.

    Shard ``s`` owns the contiguous file-position range
    ``[offsets[s], offsets[s+1])``; its positions are shard-local
    (0-based), so a global answer is ``local_pos + offsets[s]``. Shards
    partition the file range, so per-shard k-NN result lists are
    ownership-disjoint.
    """

    shards: tuple  # (S,) ParISIndex
    offsets: tuple  # (S + 1,) file-order partition bounds

    @property
    def num_shards(self) -> int:
        """Number of shards."""
        return len(self.shards)

    @property
    def num_series(self) -> int:
        """Total series across all shards."""
        return self.offsets[-1]


def build_sharded_index(index: ParISIndex, num_shards: int) -> ShardedIndex:
    """Split an assembled index into S self-contained file-order shards.

    The file order is cut into S contiguous slices whose sizes differ by at
    most one. Each shard's rows are *selected* from the full index's sorted
    arrays, not rebuilt: the leaf-order sort is stable, so the subsequence
    is exactly what ``build_index`` over the slice produces. A shard's
    ``raw`` is a view of the full index's rows, not a copy.
    """
    n = index.num_series
    if not 1 <= num_shards <= n:
        raise ValueError(f"num_shards={num_shards} outside [1, {n}]")
    base, rem = divmod(n, num_shards)
    bounds = [0]
    for s in range(num_shards):
        bounds.append(bounds[-1] + base + (1 if s < rem else 0))
    shards = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        mask = (index.pos >= lo) & (index.pos < hi)
        shards.append(assemble_index(
            index.sax[mask], index.pos[mask] - lo, index.raw[lo:hi],
            index.segments, index.cardinality))
    return ShardedIndex(tuple(shards), tuple(bounds))


def validate_index(index: ParISIndex) -> dict:
    """Structural invariants of an index (a self-check after a build)."""
    pos = index.pos.cpu().numpy()
    sax_file_order = np.zeros((index.num_series, index.segments), np.uint8)
    sax_file_order[pos] = index.sax.cpu().numpy()
    expect_sax, _ = isax.convert_to_sax(
        index.raw, index.segments, index.cardinality, normalize=False)
    root = isax.root_key(index.sax, index.cardinality).cpu().numpy()
    off = index.bucket_offsets.cpu().numpy()
    ok_perm = np.array_equal(np.sort(pos), np.arange(index.num_series))
    ok_sax = np.array_equal(sax_file_order, expect_sax.cpu().numpy())
    ok_sorted = bool(np.all(np.diff(root) >= 0))
    ok_offsets = bool(
        off[0] == 0
        and off[-1] == index.num_series
        and np.all(np.diff(off) >= 0)
        and all(
            np.all(root[off[k]: off[k + 1]] == k)
            for k in np.unique(root)
        )
    )
    return dict(
        permutation=ok_perm, sax=ok_sax, sorted=ok_sorted, offsets=ok_offsets
    )

"""The cold storage tier: disk-resident raw series behind a pointer index.

Counterpart of ``repro/core/coldtier.py``. ParIS+ is a disk-based index —
its headline result is that queries touch only the raw-series ranges their
surviving candidate leaves name, while everything else stays on disk. A
demoted component keeps its SAX summaries, positions and bucket table on
the device (a few bytes per series) and leaves the raw matrix on disk,
read lazily through ``np.memmap`` and an LRU
:class:`~repro_torch.core.block_cache.BlockCache` in host memory.

Cold epoch layout — the durable component format with ONE change, byte
for byte the reference's::

    e{N}/
      keys.npy        (m,) uint64 sorted packed refine keys
      sax.npy         (m, w) uint8, leaf order
      pos.npy         (m,) int32 component-local positions (leaf order)
      raw_leaf.npy    (m, n) f32 znormed raw, LEAF order (not file order)
      meta.json       {num_series, base, series_length, cold: true}

Raw rows are stored in leaf order, so a root bucket's series occupy one
CONTIGUOUS row range ``[bucket_offsets[key], bucket_offsets[key+1])``: the
catalog entry ``key -> (row_offset, run_length)`` names an actual byte
range of ``raw_leaf.npy``, and the approximate-search seed window (a
leaf-order slice) is one contiguous read. The pointer-index catalog
(``COLD_CATALOG.json``) and the demotion commit protocol (spill, catalog
commit, manifest commit, publish, GC) are the reference's.

Search: :class:`ColdShard` plugs into the ONE engine core
(``core.search._engine_core``) through an :class:`~repro_torch.core.
search.EngineView` and the engine's front door (``_engine_call``), as
every store does. The reference reads rows through ``jax.pure_callback``
and distances them with ``euclid_sq``; here the view's ``distances`` hook
(the port fuses gather and distance) does it in five steps each round:
the round's positions go to the host, the unique rows are read through the
block cache, staged in pinned memory, copied to the device, and the
``euclid_sq`` kernel runs over the staged rows with the positions remapped
into them. The lower bounds are ``lower_bound_sq_batch`` over the hot SAX.
Answers are bitwise the in-memory engine's: the same rows meet the same
distance kernel in the same order. Unlike the reference, which reads every
candidate of a round, the hook reads only the rows the round's mask keeps
(a candidate whose bound reaches the query's k-th best is never used), so
a query reads the raw ranges the pruning leaves and no others.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import isax
from repro_torch.core.block_cache import BlockCache, ColdReader
from repro_torch.core.build_pipeline import keys_from_u64
from repro_torch.core.device import resolve_device
from repro_torch.core.durable import (
    COLD_CATALOG, COLD_CATALOG_TMP, ComponentRef, Fault, Manifest,
    _fire, _fsync_dir, _fsync_path,
)
from repro_torch.core.index import bucket_offsets_from_keys
from repro_torch.core.search import (
    INF, EngineView, SearchConfig, SearchResult, _batch_engine, _engine_call,
    bucket_window_start,
)
from repro_torch.kernels import ops

CATALOG_FORMAT = 1
COLD_RAW = "raw_leaf.npy"
_COLD_FILES = ("keys.npy", "sax.npy", "pos.npy", COLD_RAW)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------- catalog
def read_catalog(workdir: str) -> dict:
    """The committed pointer-index catalog ({} epochs when none exists)."""
    path = os.path.join(workdir, COLD_CATALOG)
    if not os.path.exists(path):
        return dict(format=CATALOG_FORMAT, epochs={})
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != CATALOG_FORMAT:
        raise ValueError(
            f"unsupported cold catalog format {doc.get('format')!r} in "
            f"{workdir}")
    return doc


def write_catalog(workdir: str, cat: dict, fault: Fault = None) -> None:
    """Atomically commit the catalog (tmp write -> fsync -> rename)."""
    tmp = os.path.join(workdir, COLD_CATALOG_TMP)
    _fire(fault, "catalog:tmp")
    with open(tmp, "w") as f:
        json.dump(cat, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fire(fault, "catalog:replace")
    os.replace(tmp, os.path.join(workdir, COLD_CATALOG))
    _fsync_dir(workdir)
    _fire(fault, "catalog:done")


def bucket_entries(bucket_offsets) -> dict:
    """Sparse ``key -> [row_offset, run_length]`` map of non-empty buckets."""
    off = _host(bucket_offsets).astype(np.int64)
    out = {}
    for key in np.flatnonzero(np.diff(off)):
        out[str(int(key))] = [int(off[key]), int(off[key + 1] - off[key])]
    return out


def epoch_entry(workdir: str, name: str, *, base: int, num_series: int,
                series_length: int, bucket_offsets) -> dict:
    """One epoch's catalog entry, pointer ranges resolved to bytes.

    ``data_offset`` is where the ``.npy`` payload starts inside
    ``raw_leaf.npy`` (header size), so a bucket's raw bytes are
    ``data_offset + row_offset * row_bytes`` for ``run_length *
    row_bytes`` — usable by any reader without parsing the header.
    """
    path = os.path.join(workdir, name, COLD_RAW)
    row_bytes = int(series_length) * 4  # float32 rows
    data_offset = os.path.getsize(path) - num_series * row_bytes
    return dict(
        base=int(base), num_series=int(num_series),
        series_length=int(series_length), row_bytes=row_bytes,
        data_offset=int(data_offset),
        buckets=bucket_entries(bucket_offsets),
    )


def byte_range(entry: dict, key: int) -> Optional[tuple]:
    """(byte offset, byte length) of one bucket inside ``raw_leaf.npy``."""
    span = entry["buckets"].get(str(int(key)))
    if span is None:
        return None
    row_off, run_len = span
    rb = entry["row_bytes"]
    return entry["data_offset"] + row_off * rb, run_len * rb


def catalog_add(workdir: str, name: str, entry: dict,
                fault: Fault = None) -> None:
    """Incrementally add one epoch's pointer entries (atomic commit)."""
    cat = read_catalog(workdir)
    cat["epochs"][name] = entry
    write_catalog(workdir, cat, fault)


def reconcile_catalog(workdir: str, man: Manifest, shards,
                      fault: Fault = None) -> tuple:
    """Make the catalog agree with the committed manifest (recovery).

    Prunes entries for epochs the manifest's ``cold`` list does not
    confirm (the crash window between the catalog and manifest commits
    of an interrupted demotion — after the prune, ``gc_orphans`` may
    sweep the dir) and self-heals missing entries from the loaded
    shards' bucket tables. Returns (pruned, healed) dir-name lists;
    writes only when something changed.
    """
    cat = read_catalog(workdir)
    by_dir = {s.dir: s for s in shards}
    live = {ref.dir for ref in man.cold}
    pruned = [d for d in cat["epochs"] if d not in live]
    healed = [d for d in live if d not in cat["epochs"]]
    if not pruned and not healed:
        return [], []
    for d in pruned:
        del cat["epochs"][d]
    for d in healed:
        s = by_dir[d]
        cat["epochs"][d] = epoch_entry(
            workdir, d, base=s.base, num_series=s.num_series,
            series_length=s.series_length,
            bucket_offsets=s.bucket_offsets)
    write_catalog(workdir, cat, fault)
    return pruned, healed


# ----------------------------------------------------------- cold epochs
def spill_cold_component(
    workdir: str,
    name: str,
    keys: np.ndarray,
    sax: np.ndarray,
    pos_local: np.ndarray,
    raw_leaf: np.ndarray,
    *,
    base: int,
    series_length: int,
    fault: Fault = None,
) -> ComponentRef:
    """Write one cold epoch dir (fsync'd) — ``raw_leaf`` in LEAF order.

    Host arrays, keys as uint64. Same contract as
    :func:`~repro_torch.core.durable.spill_component`: the dir is complete
    before this returns; a crash mid-spill leaves a partial dir neither
    the manifest nor the catalog references, which recovery removes.
    """
    d = os.path.join(workdir, name)
    _fire(fault, f"spill:{name}:mkdir")
    os.makedirs(d, exist_ok=True)
    arrays = dict(zip(_COLD_FILES, (
        np.asarray(keys), np.asarray(sax),
        np.asarray(pos_local, np.int32),
        np.asarray(raw_leaf, np.float32))))
    for fname, arr in arrays.items():
        _fire(fault, f"spill:{name}:{fname}")
        path = os.path.join(d, fname)
        np.save(path, arr)
        _fsync_path(path)
    _fire(fault, f"spill:{name}:meta")
    meta = dict(num_series=int(len(keys)), base=int(base),
                series_length=int(series_length), cold=True)
    mpath = os.path.join(d, "meta.json")
    with open(mpath, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(d)
    _fire(fault, f"spill:{name}:done")
    return ComponentRef(dir=name, base=int(base),
                        num_series=int(len(keys)))


class ColdShard:
    """One immutable cold component: summaries on the device, raw on disk.

    On ``device``: the leaf-ordered SAX rows, component-local positions,
    the CSR bucket table, the sorted refine keys (sortable int64, see
    ``core.build_pipeline``) and the inverse permutation ``inv`` (file
    position -> leaf row) that turns the engine's file-position gathers
    into ``raw_leaf.npy`` row reads. On disk: the raw matrix, behind a
    :class:`~repro_torch.core.block_cache.ColdReader`.

    The shard owns the global file range ``[base, base + num_series)``;
    its answers carry component-local positions that callers translate
    by ``base``.
    """

    def __init__(self, *, sax, pos, keys, reader: ColdReader, base: int,
                 dir: str, series_length: int, segments: int,
                 cardinality: int, device="cuda"):
        dev = resolve_device(device)
        self.sax = torch.from_numpy(np.ascontiguousarray(sax, np.uint8)
                                    ).to(dev)
        pos_np = np.ascontiguousarray(pos, np.int32)
        self.pos = torch.from_numpy(pos_np).to(dev)
        self.keys = keys_from_u64(keys, dev)
        self.reader = reader
        self.base = int(base)
        self.dir = dir
        self.series_length = int(series_length)
        self.segments = int(segments)
        self.cardinality = int(cardinality)
        root = isax.root_key(self.sax, cardinality)
        self.bucket_offsets = bucket_offsets_from_keys(root, 2 ** segments)
        inv = torch.empty((len(pos_np),), dtype=torch.int32, device=dev)
        inv[self.pos.long()] = torch.arange(len(pos_np), dtype=torch.int32,
                                            device=dev)
        self.inv = inv

    @property
    def num_series(self) -> int:
        """Series in this cold shard."""
        return self.sax.shape[0]

    @property
    def num_buckets(self) -> int:
        """Number of root buckets."""
        return self.bucket_offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        """The device the shard's summaries live on."""
        return self.sax.device

    def bucket(self, key) -> tuple:
        """(start, end) of a root bucket in leaf order (ParISIndex API)."""
        return self.bucket_offsets[key], self.bucket_offsets[key + 1]

    # The disk boundary: the engine's per-round candidate gathers and the
    # seed window read are the ONLY places the raw file is touched.
    def _stage(self, rows: np.ndarray) -> torch.Tensor:
        """Leaf rows (any shape, flattened) -> (r, n) rows on the device,
        read through the block cache and staged in pinned memory."""
        host = torch.from_numpy(self.reader.rows(np.asarray(rows).ravel()))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)


def load_cold_shard(workdir: str, ref: ComponentRef, *, cache: BlockCache,
                    segments: int, cardinality: int,
                    device="cuda") -> ColdShard:
    """Reopen one committed cold epoch: summaries on ``device``, raw mmap'd."""
    d = os.path.join(workdir, ref.dir)
    keys, sax, pos = (
        np.load(os.path.join(d, f)) for f in _COLD_FILES[:3])
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    if meta["num_series"] != ref.num_series or meta["base"] != ref.base:
        raise ValueError(
            f"cold component {ref.dir} meta {meta} disagrees with "
            f"manifest {ref}")
    return ColdShard(
        sax=sax, pos=pos, keys=keys,
        reader=ColdReader(os.path.join(d, COLD_RAW), cache),
        base=ref.base, dir=ref.dir,
        series_length=int(meta["series_length"]),
        segments=segments, cardinality=cardinality, device=device)


# --------------------------------------------------------------- engines
def _cold_view(shard: ColdShard, *, leaf_cap: int) -> EngineView:
    """Cold-shard hooks for the ONE engine core.

    Identical to ``core.search._index_view`` except where the raw matrix
    is touched: ``distances`` maps file positions through the inverse
    permutation, reads the unique leaf rows through the block cache and
    stages them on the device; the approx seed reads its leaf window as
    one contiguous range per query — same window, same distance kernel,
    same first-row argmin, so the seeded BSF is the in-memory path's.
    """
    dev = shard.device
    bpp = isax.padded_breakpoints(shard.cardinality, dev)
    m = shard.num_series
    leaf = min(int(leaf_cap), m)

    def lower_bounds(qps, impl):
        return ops.lower_bound_sq_batch(
            qps, shard.sax, bpp, shard.series_length, impl=impl)

    def distances(qs, pos, impl, mask):
        # Only the rows some query's mask keeps are read; every other entry
        # is distanced against a staged row and then set to +inf by the
        # engine, as the in-memory path's would be. Positions clip as the
        # in-memory gather does (NO_POS is never inside a mask).
        rows = shard.inv[pos.clamp(0, m - 1).long()]
        need = mask if rows.dim() == 2 else mask.any(dim=0)
        uniq = torch.unique(rows[need]).cpu().numpy()  # sorted
        if uniq.size == 0:  # nothing survives the round's mask
            return torch.full(mask.shape, INF, device=dev)
        staged = shard._stage(uniq)
        local = torch.searchsorted(
            torch.from_numpy(uniq).to(dev), rows.contiguous())
        local = local.clamp_max(uniq.size - 1).to(torch.int32)
        return ops.euclid_sq_gather(qs, staged, local, impl=impl)

    def seed(queries, impl):
        qs = isax.znorm(queries)
        qsax = isax.sax_from_paa(isax.paa(qs, shard.segments),
                                 shard.cardinality)
        keys = isax.root_key(qsax, shard.cardinality)
        s = bucket_window_start(shard.bucket_offsets, keys, leaf, m)
        rows = s.to(torch.int64)[:, None] + torch.arange(leaf, device=dev)
        # Leaf-order window == contiguous raw_leaf rows: ONE ranged read
        # per query, the pointer-index payoff.
        staged = shard._stage(rows.cpu().numpy())
        n_q = rows.shape[0]
        local = torch.arange(n_q * leaf, dtype=torch.int32,
                             device=dev).reshape(n_q, leaf)
        d = ops.euclid_sq_gather(qs, staged, local, impl=impl)
        window = shard.pos[rows]
        j = torch.argmin(d, dim=1, keepdim=True)
        return d.gather(1, j)[:, 0], window.gather(1, j)[:, 0], leaf

    return EngineView(
        n_rows=m,
        num_series=m,
        segments=shard.segments,
        lower_bounds=lower_bounds,
        positions=lambda idx: shard.pos[idx.to(torch.int64)],
        distances=distances,
        seed=seed,
    )


def cold_exact_knn_batch(
    shard: ColdShard,
    queries,
    k: int = 1,
    round_size: int = 4096,
    impl: str = "auto",
    select: str = "topk",
    sort: bool = True,
    leaf_cap: int = 256,
    stats: bool = False,
) -> tuple:
    """Exact k-NN over one cold shard (``exact_knn_batch`` contract).

    Positions are component-local; callers translate by ``shard.base``
    exactly like any other component's answer.
    """
    out = _engine_call(
        shard, _cold_view(shard, leaf_cap=leaf_cap), queries, k=k,
        round_size=round_size, sort=sort, select=select, impl=impl)
    return out if stats else out[:2]


def cold_knn_batch_tiered(
    shard: ColdShard,
    queries,
    tier,
    k: int = 1,
    round_size: int = 4096,
    impl: str = "auto",
    select: str = "topk",
    leaf_cap: int = 256,
) -> tuple:
    """Tiered k-NN over one cold shard (``knn_batch_tiered`` contract)."""
    top_d, top_p, *_, eps = _engine_call(
        shard, _cold_view(shard, leaf_cap=leaf_cap), queries, k=k,
        round_size=round_size, select=select, impl=impl, tier=tier)
    return top_d, top_p, eps


def cold_exact_search_batch(
    shard: ColdShard, queries, cfg: SearchConfig = SearchConfig()
) -> SearchResult:
    """Exact 1-NN over one cold shard (``exact_search_batch`` contract)."""
    top_d, top_p, *rest = _engine_call(
        shard, _cold_view(shard, leaf_cap=cfg.leaf_cap), queries, k=1,
        round_size=cfg.round_size, sort=cfg.sort, select=cfg.select,
        impl=cfg.impl)
    return SearchResult(top_d[:, 0], top_p[:, 0], *rest)


def make_cold_batch_engine(
    shard: ColdShard,
    *,
    k: Optional[int] = None,
    round_size: int = 4096,
    leaf_cap: int = 256,
    sort: bool = True,
    select: str = "topk",
    impl: str = "auto",
    min_bucket: int = 1,
):
    """A routable, shape-stable batch engine over one cold shard.

    The cold counterpart of :func:`~repro_torch.core.search.
    make_batch_engine` — the same wrapper (pow2 bucket padding, tier
    plumbing, sentinel protocol) over the cold shard's view.
    """
    return _batch_engine(
        shard, lambda: _cold_view(shard, leaf_cap=leaf_cap), k=k,
        round_size=round_size, sort=sort, select=select, impl=impl,
        min_bucket=min_bucket)

"""Crash-consistent persistence for the live-ingest store (``core.ingest``).

A copy of ``repro/core/durable.py`` (numpy only): the store's files,
``MANIFEST.json`` format 2 and the ``e{N}`` component dirs, are byte for
byte the reference's, so a store spilled by either package is recovered
by the other. Callers hand it host arrays: keys as uint64
(``build_pipeline.keys_to_u64``), never the port's sortable int64 form.

The mutable index becomes durable by spilling every immutable component
(base, runs, delta shards) to an epoch-style directory — the builder's
``e{N}`` shard format (``build_pipeline._construct_epoch``: ``keys.npy``,
``sax.npy``, ``pos.npy``) extended with the component's znormed raw series
and a small meta record — under a versioned manifest that is the single
source of truth:

    workdir/
      MANIFEST.json      <- versioned, atomically replaced (tmp + rename)
      e0/                <- one immutable component per epoch dir
        keys.npy             (m,) uint64 sorted packed refine keys
        sax.npy              (m, w) uint8, leaf order
        pos.npy              (m,) int32 component-LOCAL positions
        raw.npy              (m, n) f32 znormed raw, component file order
        meta.json            {num_series, base, series_length}
      e3/ ...

Write protocol (the crash-safety contract):

  1. spill the new component fully into a fresh ``e{N}`` dir (fsync'd),
  2. commit a new manifest referencing it (write ``MANIFEST.json.tmp``,
     fsync, atomic ``os.replace``, fsync the directory),
  3. only then acknowledge the operation / publish the in-memory snapshot
     (and, for compaction, garbage-collect the retired dirs).

A crash at ANY point therefore leaves either the old manifest (plus
ignorable orphan dirs — an interrupted spill or an interrupted GC) or the
new manifest with every referenced dir complete. Recovery
(``MutableIndex.recover``) loads exactly the manifest view — bit-exact,
because every array round-trips through ``.npy`` losslessly — and removes
the orphans.

Fault injection: every step of the protocol calls ``fault(point)`` first
when a hook is installed; a raising hook simulates a kill at that point
(the kill-point sweeps in the tests walk them).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Callable, Optional, Tuple

import numpy as np

MANIFEST = "MANIFEST.json"
MANIFEST_TMP = MANIFEST + ".tmp"
# Format 2 (this repo's cold tier) adds the ``cold`` component list; v1
# stores (no cold tier) are still read — see read_manifest.
MANIFEST_FORMAT = 2
_READABLE_FORMATS = (1, 2)
_COMPONENT_FILES = ("keys.npy", "sax.npy", "pos.npy", "raw.npy")

# The cold tier's pointer-index catalog (written by ``core.coldtier``)
# lives next to the manifest. The constants and the dir scan live HERE so
# gc_orphans can honor catalog references without importing coldtier
# (coldtier imports this module's spill/fsync helpers).
COLD_CATALOG = "COLD_CATALOG.json"
COLD_CATALOG_TMP = COLD_CATALOG + ".tmp"

Fault = Optional[Callable[[str], None]]


class FaultError(RuntimeError):
    """Raised by :func:`fail_at` hooks to simulate a crash."""


def fail_at(n: int) -> Callable[[str], None]:
    """A fault hook that 'kills' the store at its ``n``-th protocol point.

    Points are counted across the store's whole life (spill file writes,
    manifest commits, GC removals — see module docstring), so a property
    test can sweep ``n`` to crash anywhere in any operation. ``n`` past
    the last point simply never fires.
    """
    state = dict(count=0)

    def hook(point: str) -> None:
        state["count"] += 1
        if state["count"] >= n + 1:
            raise FaultError(f"injected crash at point #{n}: {point}")

    return hook


def _fire(fault: Fault, point: str) -> None:
    if fault is not None:
        fault(point)


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    if os.name == "posix":
        _fsync_path(path)


@dataclasses.dataclass(frozen=True)
class ComponentRef:
    """One manifest entry: where a component lives and what range it owns."""

    dir: str  # epoch dir name (e.g. "e3"), relative to the workdir
    base: int  # global file offset of the component's first series
    num_series: int

    def to_json(self) -> dict:
        """Manifest-entry dict form."""
        return dict(dir=self.dir, base=self.base, num_series=self.num_series)

    @classmethod
    def from_json(cls, d: dict) -> "ComponentRef":
        """Inverse of :meth:`to_json`."""
        return cls(dir=d["dir"], base=int(d["base"]),
                   num_series=int(d["num_series"]))


@dataclasses.dataclass(frozen=True)
class Manifest:
    """The committed state of a durable store at one version.

    ``base`` is None for a store that started empty and has never
    major-compacted. ``runs`` and ``deltas`` are in ascending offset
    order; together with ``base`` they cover ``[0, total)`` contiguously.
    ``next_epoch`` is the first unused ``e{N}`` number (orphan dirs from
    interrupted spills may exist at or above it until recovery GCs them).
    """

    version: int
    next_epoch: int
    series_length: int
    segments: int
    cardinality: int
    refine_bits: int
    base: Optional[ComponentRef]
    runs: Tuple[ComponentRef, ...]
    deltas: Tuple[ComponentRef, ...]
    # Cold-tier components (format 2): demoted epochs whose raw series
    # stay on disk. They own the LOWEST file offsets; a live base (if
    # any) starts where the cold tier ends (its ComponentRef.base).
    cold: Tuple[ComponentRef, ...] = ()

    @property
    def num_series(self) -> int:
        """Total series across cold + base + runs + deltas."""
        n = self.base.num_series if self.base else 0
        return (n + sum(c.num_series for c in self.cold)
                + sum(r.num_series for r in self.runs)
                + sum(d.num_series for d in self.deltas))


def write_manifest(workdir: str, man: Manifest, fault: Fault = None) -> None:
    """Atomically commit ``man`` as the store's current state.

    tmp write -> fsync -> ``os.replace`` -> dir fsync: a crash before the
    replace leaves the old manifest intact (plus a stale tmp the next
    recovery removes); the replace itself is atomic on POSIX.
    """
    doc = dict(
        format=MANIFEST_FORMAT,
        version=man.version,
        next_epoch=man.next_epoch,
        series_length=man.series_length,
        segments=man.segments,
        cardinality=man.cardinality,
        refine_bits=man.refine_bits,
        base=man.base.to_json() if man.base else None,
        runs=[r.to_json() for r in man.runs],
        deltas=[d.to_json() for d in man.deltas],
        cold=[c.to_json() for c in man.cold],
    )
    tmp = os.path.join(workdir, MANIFEST_TMP)
    _fire(fault, f"commit:tmp:v{man.version}")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fire(fault, f"commit:replace:v{man.version}")
    os.replace(tmp, os.path.join(workdir, MANIFEST))
    _fsync_dir(workdir)
    _fire(fault, f"commit:done:v{man.version}")


def read_manifest(workdir: str) -> Optional[Manifest]:
    """Load the committed manifest, or None when the dir holds no store."""
    path = os.path.join(workdir, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") not in _READABLE_FORMATS:
        raise ValueError(
            f"unsupported manifest format {doc.get('format')!r} in "
            f"{workdir}")
    # Backward-compatible v1 read: pre-cold-tier stores carry no "cold"
    # list; they open as all-hot stores (and commit as format 2 from the
    # next manifest write on).
    return Manifest(
        cold=tuple(ComponentRef.from_json(c)
                   for c in doc.get("cold", ())),
        version=int(doc["version"]),
        next_epoch=int(doc["next_epoch"]),
        series_length=int(doc["series_length"]),
        segments=int(doc["segments"]),
        cardinality=int(doc["cardinality"]),
        refine_bits=int(doc["refine_bits"]),
        base=(ComponentRef.from_json(doc["base"])
              if doc["base"] is not None else None),
        runs=tuple(ComponentRef.from_json(r) for r in doc["runs"]),
        deltas=tuple(ComponentRef.from_json(d) for d in doc["deltas"]),
    )


def spill_component(
    workdir: str,
    name: str,
    keys: np.ndarray,
    sax: np.ndarray,
    pos_local: np.ndarray,
    raw: np.ndarray,
    *,
    base: int,
    series_length: int,
    fault: Fault = None,
) -> ComponentRef:
    """Write one immutable component into ``workdir/name`` (fsync'd).

    The dir is complete (all four arrays + meta, each synced, dir synced)
    before this returns — a crash mid-spill leaves a partial dir that no
    manifest references, which recovery removes.
    """
    d = os.path.join(workdir, name)
    _fire(fault, f"spill:{name}:mkdir")
    os.makedirs(d, exist_ok=True)
    arrays = dict(zip(_COMPONENT_FILES, (
        np.asarray(keys), np.asarray(sax),
        np.asarray(pos_local, np.int32), np.asarray(raw, np.float32))))
    for fname, arr in arrays.items():
        _fire(fault, f"spill:{name}:{fname}")
        path = os.path.join(d, fname)
        np.save(path, arr)
        _fsync_path(path)
    _fire(fault, f"spill:{name}:meta")
    meta = dict(num_series=int(len(keys)), base=int(base),
                series_length=int(series_length))
    mpath = os.path.join(d, "meta.json")
    with open(mpath, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(d)
    _fire(fault, f"spill:{name}:done")
    return ComponentRef(dir=name, base=int(base),
                        num_series=int(len(keys)))


def load_component(workdir: str, ref: ComponentRef,
                   mmap_mode: Optional[str] = None) -> tuple:
    """(keys, sax, pos_local, raw) host arrays of one committed component.

    ``mmap_mode="r"`` maps the arrays instead of reading them eagerly —
    the raw matrix (by far the component's bulk) then enters memory one
    page at a time as it is consumed, so recovering a large store
    (``MutableIndex.recover``) never double-buffers every raw series
    through a host copy before the device upload.
    """
    d = os.path.join(workdir, ref.dir)
    keys, sax, pos, raw = (
        np.load(os.path.join(d, f), mmap_mode=mmap_mode)
        for f in _COMPONENT_FILES)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    if meta["num_series"] != ref.num_series or meta["base"] != ref.base:
        raise ValueError(
            f"component {ref.dir} meta {meta} disagrees with manifest "
            f"{ref}")
    return keys, sax, pos, raw


def catalog_dirs(workdir: str) -> set:
    """Epoch dirs the cold-tier pointer-index catalog references.

    A minimal read of ``COLD_CATALOG.json`` (full read/write lives in
    ``core.coldtier``): just the referenced dir names, tolerant of a
    missing file (no cold tier yet). GC must treat these as live even
    when the manifest does not reference them — the demotion protocol
    commits the catalog BEFORE the manifest, so in the crash window
    between the two commits the new cold epoch is referenced only here
    (recovery reconciles the catalog back to the manifest, after which
    the dir really is an orphan).
    """
    path = os.path.join(workdir, COLD_CATALOG)
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        doc = json.load(f)
    return set(doc.get("epochs", {}))


def gc_orphans(workdir: str, man: Manifest, fault: Fault = None) -> list:
    """Remove epoch dirs neither the manifest nor the cold catalog
    references (+ stale tmp files).

    Orphans are the residue of interrupted spills and interrupted GCs;
    they are never loaded, so removal is safe at any time the manifest is
    current. A catalog-referenced dir is NEVER swept here, whatever the
    manifest says — see :func:`catalog_dirs`. Returns the removed names
    (for logging/tests).
    """
    live = {r.dir for r in man.runs} | {d.dir for d in man.deltas}
    live |= {c.dir for c in man.cold}
    live |= catalog_dirs(workdir)
    if man.base:
        live.add(man.base.dir)
    removed = []
    for entry in sorted(os.listdir(workdir)):
        path = os.path.join(workdir, entry)
        if entry in (MANIFEST_TMP, COLD_CATALOG_TMP):
            _fire(fault, f"gc:{entry}")
            os.remove(path)
            removed.append(entry)
        elif (os.path.isdir(path) and entry.startswith("e")
                and entry[1:].isdigit() and entry not in live):
            _fire(fault, f"gc:{entry}")
            shutil.rmtree(path, ignore_errors=True)
            removed.append(entry)
    return removed

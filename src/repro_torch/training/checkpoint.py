"""Atomic checkpointing in the JAX package's on-disk layout.

The port of ``repro/training/checkpoint.py``. Layout:

    <dir>/step_<N>/
        manifest.json   — leaf paths, shapes, dtypes, step
        <leaf-hash>.npy — one file per leaf of the JAX tree

A tree here is what the JAX package's ``tree_util`` would flatten: dicts
(in sorted key order), lists, tuples and NamedTuples, with numpy arrays or
tensors as leaves, and a leaf's path joins its dict keys, sequence indices
and field names with ``/``. A :class:`~repro_torch.training.train_step.
TrainState` is saved as JAX's train state ``(params, OptState)``
(``convert.train_state_to_arrays``: its per-layer tensors stacked into
JAX's leaves), so its paths are JAX's (``0/blocks/attn/wq``, ``1/step``,
``1/mu/...``), its file names JAX's ``_fname`` and its manifest written as
JAX writes it: either package restores what the other saved.

Guarantees, as in the JAX package:
  * atomicity: writes go to ``step_<N>.tmp`` and are renamed only after
    every leaf and the manifest are fsync'd; restore ignores ``.tmp``;
  * retention: keep the newest K checkpoints;
  * async: ``AsyncSaver`` snapshots to host memory synchronously and writes
    in a background thread, joined at the next save.

A bfloat16 leaf is written as JAX writes one (two bytes an element, descr
``<V2``, manifest dtype ``bfloat16``); restore reads the manifest's dtype
and returns it as a bfloat16 tensor. (The JAX package's own ``restore``
cannot place such a leaf; a train state holds none, its masters are
float32.)

Over a mesh (a state placed by ``training/sharding.py``, or DTensor
leaves), every rank calls ``save``: each leaf is gathered on rank 0 (a
collective: every rank sends its block there, ``sharding.full_on``), rank 0
alone writes, and every rank waits for the write before it returns, so
the files are the bytes an unsharded save writes.
``AsyncSaver`` gathers on the calling thread and only the write goes to
the background. ``restore(..., shardings=)`` places each leaf under its
``NamedSharding`` (a state: under ``(param_shardings,
opt_state_shardings)``), each rank reading only its block of the
memory-mapped files: a restore onto another mesh shape or world size is a
re-placement.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()):
    """(path parts, leaf) pairs in JAX's flattening order; None is an empty
    subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in
                _flatten(getattr(tree, f), prefix + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in
                _flatten(x, prefix + (str(i),))]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _sharded(tree) -> bool:
    """Whether ``tree`` (a ``TrainState`` or a tree) is placed over a
    mesh."""
    from repro_torch.models.layers import is_dtensor
    from repro_torch.training.train_step import TrainState

    if isinstance(tree, TrainState):
        return tree.mesh is not None
    return any(is_dtensor(leaf) for _, leaf in _flatten(tree))


def _snapshot(tree) -> tuple:
    """(leaf paths, host leaves, whether this rank writes): a
    ``TrainState`` as JAX's train state tree, DTensor leaves gathered (a
    collective over a mesh, where only rank 0 keeps the host copies and
    writes)."""
    from repro_torch.convert import train_state_to_arrays
    from repro_torch.training import sharding
    from repro_torch.training.train_step import TrainState

    sharded = _sharded(tree)
    writer = not sharded or torch.distributed.get_rank() == 0
    if isinstance(tree, TrainState):
        tree = train_state_to_arrays(tree, keep=writer,
                                     dst=0 if sharded else None)
    flat = _flatten(tree)
    leaves = []
    for _, leaf in flat:
        if isinstance(leaf, torch.Tensor):
            leaf = sharding.full_on(leaf, 0)  # rank 0 writes
            if leaf is not None:
                leaf = leaf.detach().cpu().clone()
        leaves.append(leaf if writer else None)
    return ["/".join(p) for p, _ in flat], leaves, writer


def _leaf_paths(tree):
    flat = _flatten(tree)
    return ["/".join(p) for p, _ in flat], [leaf for _, leaf in flat]


def _fname(leaf_path: str) -> str:
    h = hashlib.sha1(leaf_path.encode()).hexdigest()[:16]
    safe = re.sub(r"[^A-Za-z0-9_]+", "_", leaf_path)[-48:]
    return f"{safe}.{h}.npy"


def _host(leaf) -> tuple:
    """(a host numpy array of ``leaf``, its dtype's name): a bfloat16
    tensor becomes its 16-bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_npy(f, arr: np.ndarray, dtype: str) -> None:
    """``np.save`` of ``arr``; bfloat16 bits get the header JAX's
    ``np.save`` of an ml_dtypes bfloat16 array writes (descr ``<V2``)."""
    if dtype != "bfloat16":
        np.save(f, arr)
        return
    arr = np.ascontiguousarray(arr)
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    np.lib.format.write_array_header_1_0(f, header)
    f.write(arr.tobytes())


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Synchronous atomic save. Returns the final directory. Over a mesh
    every rank calls it (module docstring)."""
    sharded = _sharded(tree)
    names, leaves, writer = _snapshot(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if writer:
        _write(ckpt_dir, step, names, leaves, keep, extra)
    if sharded:
        torch.distributed.barrier()
    return final


def _records(step: int, names, leaves, extra: Optional[dict]):
    """(file name, a function that writes the file to a binary file) for
    each leaf, then for the manifest."""
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, leaf in zip(names, leaves):
        arr, dtype = _host(leaf)
        fn = _fname(name)
        manifest["leaves"].append(
            {"path": name, "file": fn, "shape": list(arr.shape),
             "dtype": dtype})
        yield fn, (lambda f, arr=arr, dtype=dtype: _write_npy(f, arr, dtype))
    yield "manifest.json", lambda f: f.write(json.dumps(manifest).encode())


def _write(ckpt_dir: str, step: int, names, leaves, keep: int,
           extra: Optional[dict]) -> None:
    """Write host leaves as the checkpoint of ``step``: to ``.tmp``,
    fsync'd, renamed; then the retention."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    for fn, emit in _records(step, names, leaves, extra):
        with open(os.path.join(tmp, fn), "wb") as f:
            emit(f)
            f.flush()
            os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _apply_retention(ckpt_dir, keep)


def encoded(tree: Any, step: int, *, extra: Optional[dict] = None):
    """Yield (file name, bytes) of every file ``save`` would write for
    ``tree`` at ``step`` (leaves, then the manifest), one at a time, in
    memory: a saved checkpoint can be checked against another tree's
    save without writing it."""
    names, leaves, writer = _snapshot(tree)
    if not writer:
        return
    for fn, emit in _records(step, names, leaves, extra):
        buf = io.BytesIO()
        emit(buf)
        yield fn, buf.getvalue()


class AsyncSaver:
    """Snapshot-then-write-in-background saver (single writer)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def wait(self):
        """Join the write in flight; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("a background checkpoint write failed") \
                from err

    def save(self, ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
             extra: Optional[dict] = None):
        """Snapshot ``tree`` to host memory now (over a mesh: the gathers,
        on this thread), write it in a thread (rank 0's only)."""
        self.wait()
        # Snapshot to host memory now (so training can mutate buffers).
        names, leaves, writer = _snapshot(tree)
        if not writer:
            return

        def run():
            try:
                _write(ckpt_dir, step, names, leaves, keep, extra)
            except Exception as exc:  # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _read(path: str, dtype: str):
    """A leaf file as numpy (memory-mapped), or as a bfloat16 tensor."""
    arr = np.load(path, mmap_mode="r")
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return arr


def _manifest_tree(d: str, manifest: dict) -> tuple:
    """A train state ``(params, OptState)`` read from the manifest's paths,
    its leaves memory-mapped (read when indexed)."""
    from repro_torch.training.optimizer import OptState

    root = {}
    for e in manifest["leaves"]:
        *keys, last = [int(k) if k.isdigit() else k
                       for k in e["path"].split("/")]
        node = root
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = _read(os.path.join(d, e["file"]), e["dtype"])
    opt = root[1]
    return root[0], OptState(step=opt["step"], mu=opt["mu"], nu=opt["nu"])


def restore(ckpt_dir: str, step: int, like: Any,
            shardings: Optional[Any] = None) -> Any:
    """Restore into the structure of ``like``.

    ``like`` is a tree whose leaves have a ``shape`` (arrays, tensors):
    the result has its structure, each leaf a host tensor of the
    manifest's dtype, or, placed under the matching ``NamedSharding`` of
    ``shardings`` (a tree like ``like``), a DTensor of this rank's block.
    Or ``like`` is a ``TrainState``: it is first placed under
    ``shardings`` = (``param_shardings``, ``opt_state_shardings``) if
    given, then filled in place, leaf by leaf (``convert.load_train_state``:
    a placed state reads each rank's blocks), and returned.
    """
    from repro_torch.convert import load_train_state
    from repro_torch.training import sharding
    from repro_torch.training.train_step import TrainState

    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if isinstance(like, TrainState):
        if shardings is not None:
            sharding.distribute_train_state(like, shardings)
        return load_train_state(like, _manifest_tree(d, manifest))
    by_path = {e["path"]: e for e in manifest["leaves"]}
    names, leaves = _leaf_paths(like)
    shard_leaves = ([leaf for _, leaf in _flatten(shardings)]
                    if shardings is not None else [None] * len(leaves))
    out = []
    for name, leaf, shard in zip(names, leaves, shard_leaves):
        if name not in by_path:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        entry = by_path[name]
        arr = _read(os.path.join(d, entry["file"]), entry["dtype"])
        want = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(
                f"leaf {name}: checkpoint shape {tuple(arr.shape)} != {want}")
        if shard is not None:
            out.append(shard.place(arr))
        else:
            out.append(arr if isinstance(arr, torch.Tensor)
                       else torch.from_numpy(np.array(arr)))
    return _unflatten(like, iter(out))


def place_tree(tree: Any, shardings: Any) -> Any:
    """``tree`` with each leaf placed under the matching ``NamedSharding``
    of ``shardings`` (a tree of the same structure)."""
    return _unflatten(tree, iter(
        [sh.place(leaf) for (_, leaf), (_, sh) in zip(_flatten(tree),
                                                      _flatten(shardings))]))


def restore_latest(ckpt_dir: str, like: Any,
                   shardings: Optional[Any] = None):
    """(``restore`` of the newest checkpoint, its step), or (None, None)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return restore(ckpt_dir, step, like, shardings), step


def _apply_retention(ckpt_dir: str, keep: int):
    steps = sorted(
        int(m.group(1)) for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)

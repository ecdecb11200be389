"""Carry an index or a packed store between the JAX package and the port.

``index_from_arrays`` takes the four arrays of a ParIS index (for example
``np.asarray(jax_index.sax)`` and friends) and returns the port's
:class:`~repro_torch.core.index.ParISIndex` on ``device``;
``index_to_arrays`` goes the other way. ``packed_from_arrays`` and
``packed_to_arrays`` do the same for a packed multi-component store
(:class:`~repro_torch.core.search.PackedComponents`), and
``dist_index_from_arrays`` for the mesh's padded, index-ordered arrays
(:class:`~repro_torch.core.distributed.DistIndex`). None of them imports
JAX: the arrays are plain numpy, so the tests can run both engines over
one identical index or packed buffer. The k-NN classifier
(:class:`~repro_torch.core.classifier.KnnClassifier`) needs nothing more:
it takes the index ``index_from_arrays`` builds and its labels as they
are, so it has no converter of its own.

``model_from_arrays`` takes a JAX model's parameter tree (``Model.
init_params``, as numpy: ``jax.tree.map(np.asarray, params)``) and returns
the port's :class:`~repro_torch.models.Model` holding the same values:
the ``blocks`` stack (axis 0) and the ``periods`` stacks (period, then
layer within it) are taken apart into the module lists, the ``prefix``
list is taken entry by entry, and each leaf is cast as the model casts it.
``cache_from_arrays`` carries a cache tree (the layouts are the same) to
the port's device, so a JAX cache can feed the port's ``decode_step``.

``train_state_from_arrays`` takes a JAX train state, the tuple ``(params,
OptState(step, mu, nu))`` of numpy arrays, and returns the port's
:class:`~repro_torch.training.train_step.TrainState`: the model, the
float32 masters (the tree's float32 parameters), the moments and the
step; ``load_train_state`` fills an existing state the same way.
``train_state_to_arrays`` goes back, stacking the per-layer tensors into
JAX's leaves; the checkpoint writes that tree, so either package restores
what the other saved. For a state placed over a mesh, ``load_train_state``
copies each rank's block of every leaf (read from a memory-mapped file, a
block at a time) and ``train_state_to_arrays`` gathers every leaf on every
rank, or on one rank (``dst``, the checkpoint's writer) (a collective),
keeping the host arrays only where ``keep`` is set.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.distributed import DistIndex
from repro_torch.core.index import ParISIndex
from repro_torch.core.search import PackedComponents
from repro_torch.models import Model
from repro_torch.models.model import jax_leaf
from repro_torch.models.layers import is_dtensor
from repro_torch.training import sharding
from repro_torch.training.optimizer import OptState
from repro_torch.training.train_step import TrainState, init_train_state


def index_from_arrays(sax, pos, bucket_offsets, raw, series_length: int,
                      segments: int, cardinality: int,
                      device="cuda") -> ParISIndex:
    """numpy arrays (sorted SAX, pos, offsets, file-order raw) -> index."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    index = ParISIndex(
        sax=put(sax, torch.uint8),
        pos=put(pos, torch.int32),
        bucket_offsets=put(bucket_offsets, torch.int32),
        raw=put(raw, torch.float32),
        series_length=int(series_length),
        segments=int(segments),
        cardinality=int(cardinality),
    )
    n = index.num_series
    if index.sax.shape != (n, index.segments):
        raise ValueError(f"sax shape {tuple(index.sax.shape)} != ({n}, "
                         f"{index.segments})")
    if index.pos.shape != (n,) or index.raw.shape != (n, index.series_length):
        raise ValueError("pos/raw do not match the sax rows")
    if index.bucket_offsets.shape != (2 ** index.segments + 1,):
        raise ValueError("bucket_offsets must have 2**segments + 1 entries")
    return index


def index_to_arrays(index: ParISIndex) -> dict:
    """The index's arrays as host numpy arrays plus its static sizes."""
    return dict(
        sax=index.sax.cpu().numpy(),
        pos=index.pos.cpu().numpy(),
        bucket_offsets=index.bucket_offsets.cpu().numpy(),
        raw=index.raw.cpu().numpy(),
        series_length=index.series_length,
        segments=index.segments,
        cardinality=index.cardinality,
    )


def packed_from_arrays(sax, gpos, block_len, raw, num_series: int, block: int,
                       series_length: int, segments: int, cardinality: int,
                       device="cuda") -> PackedComponents:
    """numpy arrays of a packed store (buffers + file-order raw) -> store."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    packed = PackedComponents(
        sax=put(sax, torch.uint8),
        gpos=put(gpos, torch.int32),
        block_len=put(block_len, torch.int32),
        raw=put(raw, torch.float32),
        num_series=int(num_series),
        block=int(block),
        series_length=int(series_length),
        segments=int(segments),
        cardinality=int(cardinality),
    )
    n_pad = packed.sax.shape[0]
    if packed.sax.shape != (n_pad, packed.segments) or n_pad % packed.block:
        raise ValueError(f"sax shape {tuple(packed.sax.shape)} is not "
                         f"(N_pad, {packed.segments}) in blocks of "
                         f"{packed.block}")
    if packed.gpos.shape != (n_pad,):
        raise ValueError("gpos does not match the sax rows")
    if packed.block_len.shape != (n_pad // packed.block,):
        raise ValueError("block_len must have one entry per block")
    if packed.raw.shape != (packed.num_series, packed.series_length):
        raise ValueError("raw must be (num_series, series_length)")
    return packed


def packed_to_arrays(packed: PackedComponents) -> dict:
    """The packed store's arrays as host numpy arrays plus its static sizes."""
    return dict(
        sax=packed.sax.cpu().numpy(),
        gpos=packed.gpos.cpu().numpy(),
        block_len=packed.block_len.cpu().numpy(),
        raw=packed.raw.cpu().numpy(),
        num_series=packed.num_series,
        block=packed.block,
        series_length=packed.series_length,
        segments=packed.segments,
        cardinality=packed.cardinality,
    )


def dist_index_from_arrays(sax, raw_sorted, pos, series_length: int,
                           segments: int, cardinality: int,
                           device="cuda") -> DistIndex:
    """numpy arrays of a mesh index (padded, index order) -> ``DistIndex``."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    dindex = DistIndex(
        sax=put(sax, torch.uint8),
        raw_sorted=put(raw_sorted, torch.float32),
        pos=put(pos, torch.int32),
        series_length=int(series_length),
        segments=int(segments),
        cardinality=int(cardinality),
    )
    n = dindex.num_rows
    if dindex.sax.shape != (n, dindex.segments):
        raise ValueError(f"sax shape {tuple(dindex.sax.shape)} != ({n}, "
                         f"{dindex.segments})")
    if (dindex.pos.shape != (n,)
            or dindex.raw_sorted.shape != (n, dindex.series_length)):
        raise ValueError("pos/raw_sorted do not match the sax rows")
    return dindex


def _leaf(tree, name: str) -> np.ndarray:
    """The JAX tree's array for the port parameter ``name``
    (``models.model.jax_leaf``: its leaf's path, then its index along the
    leaf's stacking axes)."""
    path, stack = jax_leaf(name)
    node = tree
    for key in path:
        node = node[key]
    return node[stack] if stack else node


def _tree_size(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_size(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_size(v) for v in tree)
    return int(np.asarray(tree).size)


def model_from_arrays(cfg, tree, device="cuda") -> Model:
    """A JAX parameter tree of numpy arrays -> the port's ``Model``."""
    model = Model(cfg, device=device)
    for name, param in model.named_parameters():
        arr = _leaf(tree, name)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: tree shape {arr.shape} != "
                             f"{tuple(param.shape)}")
        param.data = torch.from_numpy(np.array(arr, np.float32)).to(
            device=param.device, dtype=param.dtype)
    n_port = sum(p.numel() for p in model.parameters())
    if n_port != _tree_size(tree):
        raise ValueError(f"the tree holds {_tree_size(tree)} values, the "
                         f"model {n_port}")
    return model


def cache_from_arrays(tree, device="cuda"):
    """A cache tree of numpy arrays (JAX's layout) -> tensors on
    ``device``, bfloat16 leaves included."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: cache_from_arrays(v, dev) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def _tensor(x) -> torch.Tensor:
    """A host array (numpy, or a CPU tensor) as a tensor of its own."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def load_train_state(state: TrainState, tree) -> TrainState:
    """Fill ``state`` in place from a JAX train state ``(params,
    OptState)`` of host arrays: masters, moments and step, then the
    model's compute copies from the masters. A DTensor leaf takes this
    rank's block of the array."""
    params, opt = tree
    with torch.no_grad():
        for i, name in enumerate(state.names):
            for dst, src in ((state.master[i], params), (state.opt.mu[i],
                                                         opt.mu),
                             (state.opt.nu[i], opt.nu)):
                arr = _leaf(src, name)
                if tuple(arr.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}: tree shape {tuple(arr.shape)}"
                                     f" != {tuple(dst.shape)}")
                if is_dtensor(dst):
                    arr = np.ascontiguousarray(arr[sharding.local_block(
                        dst.shape, dst.device_mesh, dst.placements)])
                sharding.local(dst).copy_(_tensor(arr))
        state.opt.step.copy_(_tensor(opt.step))
    state.refresh()
    return state


def train_state_from_arrays(cfg, tree, device="cuda") -> TrainState:
    """A JAX train state ``(params, OptState)`` of numpy arrays -> the
    port's ``TrainState`` on ``device``."""
    model = model_from_arrays(cfg, tree[0], device)
    return load_train_state(init_train_state(model), tree)


def _host_array(t, keep: bool = True, dst=None):
    """A tensor's global value as a host numpy array (a DTensor is gathered
    on every rank, or on rank ``dst`` alone: a collective), or None where
    ``keep`` is unset."""
    if is_dtensor(t):
        if dst is None:
            t = t.full_tensor()
        else:
            from repro_torch.training.sharding import full_on

            t = full_on(t, dst)
    return t.detach().cpu().numpy() if keep else None


def _stack_tree(names, tensors, keep: bool = True, dst=None):
    """Per-parameter tensors -> JAX's parameter tree of numpy arrays: the
    parameters of one leaf stacked along its stacking axes, ``prefix`` a
    list (None where ``keep`` is unset, after the same gathers)."""
    if not keep:
        for t in tensors:
            _host_array(t, keep=False, dst=dst)
        return None
    groups = {}
    for name, t in zip(names, tensors):
        path, stack = jax_leaf(name)
        groups.setdefault(path, []).append((stack, _host_array(t, dst=dst)))
    tree = {}
    for path, items in groups.items():
        arr = items[0][1]
        if items[0][0]:
            lead = tuple(1 + max(s[k] for s, _ in items)
                         for k in range(len(items[0][0])))
            arr = np.empty(lead + arr.shape, arr.dtype)
            for stack, a in items:
                arr[stack] = a
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    return lists(tree)


def train_state_to_arrays(state: TrainState, keep: bool = True,
                          dst=None) -> tuple:
    """The port's ``TrainState`` -> JAX's train state ``(params,
    OptState(step, mu, nu))`` of host numpy arrays (float32 parameters:
    the masters). Over a mesh every rank must call it (each leaf is
    gathered on every rank, or with ``dst`` on that rank alone, which must
    then be the one that keeps); ``keep`` unset leaves None in place of
    the arrays."""
    return (_stack_tree(state.names, state.master, keep, dst),
            OptState(step=state.opt.step.cpu().numpy(),
                     mu=_stack_tree(state.names, state.opt.mu, keep, dst),
                     nu=_stack_tree(state.names, state.opt.nu, keep, dst)))

"""Sharding policy: logical-axis rules and parameter placements over a
``DeviceMesh``.

The port of ``repro/training/sharding.py`` (its ``:28-158``). Baseline
layout, as in the JAX package:

  * weights: tensor-parallel over ``model`` on the heads/ffn/vocab axis and
    FSDP over ``data`` on the other axis (masters and moments inherit the
    same placements: ZeRO-3);
  * activations: batch over (``pod``, ``data``); heads / mlp / experts /
    vocab over ``model``;
  * the ``pod`` axis is pure data parallelism (gradient reduction only).

Param rules are name-based over the parameter's path in the JAX package's
tree (``models.model.jax_leaf``); every rule skips axes whose size doesn't
divide the mesh axis (replication on that axis), so the same rules serve
every arch config.

PyTorch's idiom for the JAX package's ``NamedSharding``: a spec is a tuple
of mesh-axis names (``None``, a name, or a tuple of names) per tensor
dimension, as a ``PartitionSpec``; :class:`NamedSharding` pairs it with a
``DeviceMesh`` and turns it into DTensor placements (``Shard(d)`` on each
named mesh dim, ``Replicate()`` elsewhere). Placing a tensor
(:func:`place`, the port's ``jax.device_put``) slices each rank's block
out of a value every rank holds in full (or a memory-mapped file), with no
collective. :func:`shard_model` places a model's parameters,
:func:`distribute_train_state` a whole ``TrainState`` (parameters,
float32 masters and moments; the step stays a plain tensor, replicated),
and :func:`shard_batch` a batch over the batch axes. The same
``make_train_step`` then runs on the placed state: inside the forward each
layer gathers its parameters over every axis but ``model``
(``models/model.py``), and the gradients come back reduce-scattered into
the stored placements.

:func:`run_plan` is the rank entry point of the tests and of
``chip_smoke.py`` (``core.distributed.spawn_mesh`` starts the ranks).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as layers_mod
from repro_torch.models.model import jax_leaf, jax_shape


# logical activation axis -> mesh axes (see models/layers.py:logical)
def activation_rules(mesh, batch_axes: Sequence[str]):
    """The activation rules over ``mesh``: batch over ``batch_axes``, the
    head / mlp / vocab / expert axes over ``model`` when it has size > 1."""
    sizes = axis_sizes(mesh)
    has_model = "model" in sizes and sizes["model"] > 1
    model = "model" if has_model else None
    return {
        "batch": tuple(batch_axes),
        "seq": None,
        "embed": None,
        "heads": model,
        "kv_heads": model,
        "mlp": model,
        "vocab": model,
        "expert": model,
    }


def use_logical_rules(mesh, batch_axes: Sequence[str] = ("data",),
                      extra: Optional[dict] = None):
    """Install activation-sharding rules (affects layers.logical).

    ``extra``: overrides merged on top (e.g. {"seq": "model"} turns on
    sequence-parallel activations)."""
    rules = activation_rules(mesh, batch_axes)
    if extra:
        rules.update(extra)
    layers_mod.set_logical_rules(rules, mesh)


def clear_logical_rules():
    """Remove the rules: ``layers.logical`` is the identity again."""
    layers_mod.set_logical_rules(None, None)


def axis_sizes(mesh) -> dict:
    """Mesh axis name -> size, for a ``DeviceMesh`` or any object with a
    ``shape`` dict (as the JAX package's ``Mesh.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

# (regex over path, spec builder over trailing named dims). The builder gets
# the *unstacked* trailing dims; leading stack dims (layers / periods /
# sub-stacks) are padded with None automatically by rank.
_MATRIX_RULES = [
    # moe routed experts FIRST (so the generic rules can't claim them):
    # EP over model on the expert dim, (E, d, f) trailing dims.
    (r"moe/wi_gate$", ("ep", None, None)),
    (r"moe/wi_up$", ("ep", None, None)),
    (r"moe/wo$", ("ep", None, None)),
    (r"router$", (None, None)),
    # moe shared experts: plain TP
    (r"shared/wi_gate$", ("fsdp", "tp")),
    (r"shared/wi_up$", ("fsdp", "tp")),
    (r"shared/wo$", ("tp", "fsdp")),
    # attention projections
    (r"(attn|mix)/wq$", ("fsdp", "tp")),
    (r"(attn|mix)/wk$", ("fsdp", "tp")),
    (r"(attn|mix)/wv$", ("fsdp", "tp")),
    (r"(attn|mix)/wo$", ("tp", "fsdp")),
    # rwkv timemix / channelmix
    (r"tm/(wr|wk|wv|wg)$", ("fsdp", "tp")),
    (r"tm/wo$", ("tp", "fsdp")),
    (r"tm/(w1|w2)$", (None, None)),
    (r"cm/wk$", ("fsdp", "tp")),
    (r"cm/wv$", ("tp", "fsdp")),
    # mamba
    (r"mix/in_proj$", ("fsdp", "tp")),
    (r"mix/out_proj$", ("tp", "fsdp")),
    (r"mix/x_to_bc$", ("tp", None)),
    (r"mix/x_to_dt$", ("tp", None)),
    (r"mix/dt_proj$", (None, "tp")),
    # dense mlp
    (r"wi_gate$", ("fsdp", "tp")),
    (r"wi_up$", ("fsdp", "tp")),
    (r"(mlp)/wi$", ("fsdp", "tp")),
    (r"/wo$", ("tp", "fsdp")),
    # embeddings / head: vocab over model (TP logits), embed over data
    (r"embed/table$", ("tp", "fsdp")),
    (r"lm_head/w$", ("fsdp", "tp")),
    (r"frontend/proj$", (None, "fsdp")),
]


def param_pspec(name: str, shape: Sequence[int], *,
                fsdp_axis: Optional[str], tp_axis: Optional[str],
                mesh) -> tuple:
    """Resolve one parameter's spec by name rules + divisibility.

    ``name`` is a ``named_parameters`` name, ``shape`` its leaf's shape in
    the JAX package's stacked tree (``models.model.jax_shape``: the
    stacking axes first). The rule is applied to that shape, as JAX applies
    it, and the stacking axes are then dropped: the result is the spec of
    the port's (unstacked) parameter."""
    path, stack = jax_leaf(name)
    ps = "/".join(str(k) for k in path)
    sizes = axis_sizes(mesh)
    ndim = len(shape)

    def axis_ok(rule_name, dim):
        if rule_name is None:
            return None
        mesh_axes = {"fsdp": fsdp_axis, "tp": tp_axis, "ep": tp_axis}
        ax = mesh_axes.get(rule_name, rule_name)
        if ax is None or ax not in sizes:
            return None
        return ax if dim % sizes[ax] == 0 else None

    for pat, dims in _MATRIX_RULES:
        if re.search(pat, ps):
            n = len(dims)
            if ndim < n:
                return ()
            lead = (None,) * (ndim - n)
            tail = tuple(axis_ok(d, shape[ndim - n + i])
                         for i, d in enumerate(dims))
            return (lead + tail)[len(stack):]
    return ()  # norms, biases, scalars: replicated


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec (one entry per tensor dimension: None, a mesh-axis name or a
    tuple of them; missing trailing entries are None) over a
    ``DeviceMesh``: the port's ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        """The DTensor placements, one per mesh dim."""
        return spec_placements(self.mesh, self.spec)

    def place(self, x) -> torch.Tensor:
        """:func:`place` ``x`` under this sharding."""
        return place(x, self.mesh, self.placements)


def spec_placements(mesh, spec: Sequence) -> tuple:
    """A spec's DTensor placements on ``mesh``: ``Shard(d)`` on each mesh
    dim that dimension ``d`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    dims = mesh.mesh_dim_names
    out = [Replicate()] * len(dims)
    for d, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            i = dims.index(ax)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {ax!r} named twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks of ``mesh`` live on."""
    from repro_torch.core.device import resolve_device

    return resolve_device(mesh.device_type)


def local_block(shape, mesh, placements) -> tuple:
    """This rank's block of a tensor of global ``shape``: one slice a
    dimension. The offsets are plain integers, computed outside any
    ``FakeTensorMode`` (under one, DTensor's coordinate arithmetic would
    read a fake scalar)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    with unset_fake_temporarily():
        lshape, offset = compute_local_shape_and_global_offset(
            tuple(int(d) for d in shape), mesh, placements)
    return tuple(slice(int(o), int(o) + int(n))
                 for o, n in zip(offset, lshape))


def place(x, mesh, placements) -> torch.Tensor:
    """A DTensor of ``x`` (a tensor or a numpy array, the same global value
    on every rank) under ``placements``: each rank copies its own block to
    its device, with no collective (``jax.device_put``)."""
    from torch.distributed.tensor import DTensor

    placements = tuple(placements)
    block = local_block(x.shape, mesh, placements)
    if isinstance(x, torch.Tensor):
        local = x.detach()
        for d, s in enumerate(block):  # narrow: no device guard (fake CUDA)
            local = local.narrow(d, s.start, s.stop - s.start)
        dev = mesh_device(mesh)
        local = (local.clone() if local.device == dev
                 else local.to(dev, copy=True))
    else:
        local = torch.from_numpy(np.ascontiguousarray(x[block])).to(
            mesh_device(mesh))
    shape = tuple(x.shape)
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              shape=torch.Size(shape), stride=stride)


def param_shardings(model: nn.Module, mesh, *,
                    fsdp_axis: Optional[str] = "data",
                    tp_axis: Optional[str] = "model") -> dict:
    """``NamedSharding`` of every parameter of ``model``, by name
    (``named_parameters`` order)."""
    return {name: NamedSharding(mesh, param_pspec(
        name, jax_shape(model, name, p), fsdp_axis=fsdp_axis,
        tp_axis=tp_axis, mesh=mesh))
        for name, p in model.named_parameters()}


def opt_state_shardings(opt_state, param_shard_tree: dict, mesh):
    """Optimizer state: step replicated; moments follow the param specs."""
    from repro_torch.training.optimizer import OptState

    rep = NamedSharding(mesh, ())
    specs = list(param_shard_tree.values())
    return OptState(step=rep, mu=specs, nu=specs)


def _owner(model: nn.Module, name: str) -> tuple:
    mod, _, attr = name.rpartition(".")
    return (model.get_submodule(mod) if mod else model), attr


def shard_model(model: nn.Module, mesh, *, fsdp_axis: Optional[str] = "data",
                tp_axis: Optional[str] = "model",
                source: Optional[dict] = None) -> nn.Module:
    """Replace every parameter of ``model`` by its DTensor under
    :func:`param_shardings`, in place, and turn on the per-layer gather of
    the forward (all mesh dims but ``tp_axis``'s). The values come from
    the parameters themselves or, by name, from ``source`` (full tensors
    that every rank holds, on any device: a CUDA tensor received by IPC,
    or a host copy)."""
    shardings = param_shardings(model, mesh, fsdp_axis=fsdp_axis,
                                tp_axis=tp_axis)
    for name, p in list(model.named_parameters()):
        full = p if source is None else source[name]
        if tuple(full.shape) != tuple(p.shape):
            raise ValueError(f"{name}: source shape {tuple(full.shape)} != "
                             f"{tuple(p.shape)}")
        dt = shardings[name].place(full)
        if dt.dtype != p.dtype:
            dt = dt.to(p.dtype)
        owner, attr = _owner(model, name)
        setattr(owner, attr, nn.Parameter(dt, requires_grad=p.requires_grad))
    model.gather_keep = tuple(i for i, n in enumerate(mesh.mesh_dim_names)
                              if n == tp_axis)
    return model


def distribute_train_state(state, shardings, *,
                           tp_axis: Optional[str] = "model"):
    """Place a ``TrainState`` (every rank holding the same values) under
    ``shardings`` = (:func:`param_shardings`, :func:`opt_state_shardings`):
    the model's parameters, the float32 masters and the moments become
    DTensors, leaf by leaf; the step stays a plain tensor (replicated). A
    float32 parameter stays its own master. The forward then gathers each
    layer's parameters over every mesh dim but ``tp_axis``'s. Returns
    ``state``, changed in place."""
    pshard, oshard = shardings
    model = state.model
    own = [m.data_ptr() == p.data_ptr() for p, m in
           zip(state.params, state.master)]
    mesh = next(iter(pshard.values())).mesh
    keep = tuple(i for i, n in enumerate(mesh.mesh_dim_names)
                 if n == tp_axis)
    for i, name in enumerate(state.names):
        p = state.params[i]
        dt = pshard[name].place(p)
        owner, attr = _owner(model, name)
        setattr(owner, attr, nn.Parameter(dt, requires_grad=p.requires_grad))
        state.params[i] = getattr(owner, attr)
        state.master[i] = (state.params[i].detach() if own[i]
                           else pshard[name].place(state.master[i]))
        state.opt.mu[i] = oshard.mu[i].place(state.opt.mu[i])
        state.opt.nu[i] = oshard.nu[i].place(state.opt.nu[i])
    model.gather_keep = keep
    return state


def shard_batch(batch: dict, mesh, batch_axes: Sequence[str] = ("data",)):
    """A global batch (the same on every rank) as DTensors with their rows
    sharded over ``batch_axes``."""
    spec = (tuple(a for a in batch_axes if a in mesh.mesh_dim_names),)
    return {k: place(v, mesh, spec_placements(mesh, spec))
            for k, v in batch.items()}


def full(x):
    """A DTensor's global value on every rank (a collective); a plain
    tensor as it is."""
    return x.full_tensor() if layers_mod.is_dtensor(x) else x


def full_on(x, dst: int = 0):
    """A DTensor's global value on rank ``dst`` alone, None on the others
    (every rank of the mesh calls it): each rank sends its block to
    ``dst`` (``dist.gather``), where :func:`full`'s all-gather would send
    every block to every rank. A plain tensor as it is. Over ``gloo`` the
    blocks go through the host (its gather takes host tensors). A mesh
    that is not the whole world, or a 0-d tensor, is gathered by
    :func:`full`."""
    import math

    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    if not layers_mod.is_dtensor(x):
        return x
    mesh, me = x.device_mesh, dist.get_rank()
    world = dist.get_world_size()
    if math.prod(mesh.shape) != world or x.dim() == 0:
        out = x.full_tensor()
        return out if me == dst else None
    local = x.to_local().detach()
    if dist.get_backend() == "gloo":
        local = local.cpu()
    local = local.contiguous().reshape(-1)
    block = local_block(x.shape, mesh, x.placements)
    # every rank pads its block to the largest a rank can hold
    parts = [math.prod(mesh.size(i) for i, pl in enumerate(x.placements)
                       if isinstance(pl, Shard) and pl.dim == d)
             for d in range(x.dim())]
    cap = math.prod(-(-n // p) for n, p in zip(x.shape, parts))
    meta = torch.tensor([v for s in block for v in (s.start, s.stop)],
                        dtype=torch.int64, device=local.device)
    buf = local.new_zeros(cap)
    buf[:local.numel()] = local
    metas = [torch.empty_like(meta) for _ in range(world)] if me == dst \
        else None
    bufs = [torch.empty_like(buf) for _ in range(world)] if me == dst \
        else None
    dist.gather(meta, metas, dst=dst)
    dist.gather(buf, bufs, dst=dst)
    if me != dst:
        return None
    out = torch.empty(tuple(x.shape), dtype=x.dtype, device=buf.device)
    for m, b in zip(metas, bufs):
        m = m.tolist()
        sl = tuple(slice(m[2 * i], m[2 * i + 1]) for i in range(x.dim()))
        shape = tuple(s.stop - s.start for s in sl)
        out[sl] = b[:math.prod(shape)].view(shape)
    return out


def local(x):
    """A DTensor's block on this rank; a plain tensor as it is."""
    return x.to_local() if layers_mod.is_dtensor(x) else x


def mesh_ops(state_or_model):
    """The context a sharded state's step runs in: plain tensors (the
    step, constants) mix with DTensors as replicated ones. A no-op for a
    plain state."""
    import contextlib

    model = getattr(state_or_model, "model", state_or_model)
    if getattr(model, "gather_keep", None) is None:
        return contextlib.nullcontext()
    return layers_mod.replicated_constants()


# ---------------------------------------------------------------------------
# The rank entry point of the tests and of chip_smoke.py
# ---------------------------------------------------------------------------

_STAGED = []  # the host-staged collectives' registration, kept alive


def stage_collectives_through_host() -> None:
    """Run DTensor's collectives on CUDA tensors over a ``gloo`` group as
    host copies and classic ``torch.distributed`` calls.

    Several gloo ranks share one card where NCCL cannot place them. In the
    card machine's PyTorch (2.11) gloo's classic collectives take CUDA
    tensors (they copy through the host themselves), but the functional
    collectives that DTensor issues (``_c10d_functional``) crash the rank
    (SIGSEGV). This registers CUDA kernels for those ops that copy the
    operand to the host, call the classic collective there and copy the
    result back: the same values, synchronously. Only for processes whose
    process group is gloo; an NCCL group keeps its own kernels."""
    if _STAGED:
        return
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    def group(name):
        return c10d._resolve_process_group(name)

    def op(name):
        return {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
                "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
                "product": dist.ReduceOp.PRODUCT}[name.lower()]

    def host(x):
        return x.detach().cpu().contiguous()

    def all_reduce(x, reduce_op, group_name):
        g = group(group_name)
        h = host(x).clone()
        dist.all_reduce(h, op=op(reduce_op), group=g)
        if reduce_op.lower() == "avg":
            h /= dist.get_world_size(g)
        return h.to(x.device)

    def all_gather_into_tensor(x, group_size, group_name):
        h = host(x)
        out = torch.empty((h.shape[0] * group_size, *h.shape[1:]),
                          dtype=h.dtype)
        dist.all_gather_into_tensor(out, h, group=group(group_name))
        return out.to(x.device)

    def reduce_scatter_tensor(x, reduce_op, group_size, group_name):
        g = group(group_name)
        h = host(x)
        out = torch.empty((h.shape[0] // group_size, *h.shape[1:]),
                          dtype=h.dtype)
        dist.reduce_scatter_tensor(out, h, op=op(reduce_op), group=g)
        if reduce_op.lower() == "avg":
            out /= group_size
        return out.to(x.device)

    def all_to_all_single(x, out_splits, in_splits, group_name):
        h = host(x)
        out = torch.empty((sum(out_splits), *h.shape[1:]), dtype=h.dtype)
        dist.all_to_all_single(out, h, list(out_splits), list(in_splits),
                               group=group(group_name))
        return out.to(x.device)

    def broadcast(x, src, group_name):
        h = host(x).clone()
        dist.broadcast(h, src, group=group(group_name))
        return h.to(x.device)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for fn in (all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
               all_to_all_single, broadcast):
        lib.impl(fn.__name__, fn, "CUDA")
    _STAGED.append(lib)

def _mesh(rank_mesh, shape: Sequence[int],
                axes: Sequence[str] = ("data", "model")):
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) ranks of
    the process group of ``rank_mesh`` (a ``core.distributed.Mesh``)."""
    from repro_torch.launch.mesh import make_debug_mesh

    return make_debug_mesh(tuple(shape), tuple(axes),
                           device_type=rank_mesh.device.type)


def _state_bytes(state) -> int:
    """Bytes this rank holds of a state: the compute copies, the separate
    masters and both moments."""
    tensors = list(state.params) + [
        m for p, m in zip(state.params, state.master)
        if m.data_ptr() != p.data_ptr()] + list(state.opt.mu) + list(
            state.opt.nu)
    return sum(local(t).numel() * local(t).element_size() for t in tensors)


def _max_rel(got, want) -> float:
    """max |got - want| over the leaf's largest |want| (``got`` a DTensor
    block or a plain tensor; ``want`` the full leaf)."""
    scale = max(float(want.abs().max()), 1e-30)
    if layers_mod.is_dtensor(got):
        want = want[local_block(got.shape, got.device_mesh, got.placements)]
        got = got.to_local()
    return float((got.double() - want.to(got.device).double()).abs().max()
                 ) / scale


def _max_abs(got, want) -> float:
    if layers_mod.is_dtensor(got):
        want = want[local_block(got.shape, got.device_mesh, got.placements)]
        got = got.to_local()
    return float((got.double() - want.to(got.device).double()).abs().max())


def _build_model(cfg, dev, init, remat: bool):
    """A plain model on ``dev`` (``init``: an int seed for a generator on
    the device, or a JAX parameter tree of numpy arrays), or an empty one
    on the host (``init`` None: its values come from ``source`` or a
    checkpoint)."""
    from repro_torch import convert
    from repro_torch.models import Model

    if init is None:
        return Model(cfg, device="cpu", remat=remat)
    if isinstance(init, int):
        return Model(cfg, device=dev, remat=remat,
                     generator=torch.Generator(dev).manual_seed(init))
    model = convert.model_from_arrays(cfg, init, dev)
    model.remat = remat
    return model


def _train(rank_mesh, kw: dict) -> dict:
    """One ``"train"`` step of :func:`run_plan`."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import convert
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training import train_step as ts_mod

    dev = rank_mesh.device
    cfg, tcfg = kw["cfg"], kw["tcfg"]
    mesh = _mesh(rank_mesh, kw["shape"], kw.get("axes",
                                                      ("data", "model")))
    batch_axes = kw.get("batch_axes", ("data",))
    use_logical_rules(mesh, batch_axes)
    try:
        model = _build_model(cfg, dev, kw.get("init"), kw.get("remat", False))
        shard_model(model, mesh, source=kw.get("source"))
        state = ts_mod.init_train_state(model)
        if "restore" in kw:
            ckpt_mod.restore(kw["restore"][0], kw["restore"][1], state)
        step_fn = ts_mod.make_train_step(model, tcfg)
        out = dict(losses=[], grad_norms=[], state_bytes=_state_bytes(state))
        batches = [shard_batch({k: torch.from_numpy(np.asarray(v))
                                for k, v in b.items()}, mesh, batch_axes)
                   for b in kw["batches"]]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        t0 = time.perf_counter()
        with CommDebugMode() as comm:
            if "ref_grads" in kw:  # the first batch's gradients, held
                with mesh_ops(state):
                    loss, _ = ts_mod.make_loss_fn(model, tcfg)(batches[0])
                    grads = torch.autograd.grad(loss, state.params)
                out["grad_loss"] = float(full(loss.detach()))
                out["grad_err"] = max(
                    _max_rel(g, kw["ref_grads"][n])
                    for n, g in zip(state.names, grads))
                del grads, loss
            for i, b in enumerate(batches):
                state, m = step_fn(state, b)
                out["losses"].append(float(m["loss"]))
                out["grad_norms"].append(float(m["grad_norm"]))
                for step, d in kw.get("save", {}).items():
                    if step == int(state.opt.step):
                        ckpt_mod.save(d, step, state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
        out["seconds"] = time.perf_counter() - t0
        out["collectives"] = int(comm.get_total_counts())
        if "ref_master" in kw:
            out["master_err"] = max(
                _max_abs(m, kw["ref_master"][n])
                for n, m in zip(state.names, state.master))
        if kw.get("return_state"):
            out["state"] = convert.train_state_to_arrays(state)
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
        return out
    finally:
        clear_logical_rules()


def _plain_vs_sharded(rank_mesh, kw: dict) -> dict:
    """``"plain_vs_sharded"``: the same generator-made model and batches
    through the plain state and through the state distributed over a
    one-rank mesh; losses, grad norms and masters compared bit for bit."""
    from repro_torch.models import Model
    from repro_torch.training import train_step as ts_mod

    dev = rank_mesh.device
    cfg, tcfg = kw["cfg"], kw["tcfg"]
    batches = [{k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in b.items()} for b in kw["batches"]]
    out = {}
    runs = {}
    for kind in ("plain", "sharded"):
        model = Model(cfg, device=dev, remat=kw.get("remat", True),
                      generator=torch.Generator(dev).manual_seed(kw["seed"]))
        mesh = None
        if kind == "sharded":
            mesh = _mesh(rank_mesh, (1,) * len(kw["axes"]), kw["axes"])
            use_logical_rules(mesh, ("data",))
            shard_model(model, mesh)
        try:
            state = ts_mod.init_train_state(model)
            step_fn = ts_mod.make_train_step(model, tcfg)
            losses, norms, secs = [], [], []
            for b in batches:
                if mesh is not None:
                    b = shard_batch(b, mesh)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, m = step_fn(state, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                secs.append(time.perf_counter() - t0)
            runs[kind] = (losses, norms, [local(x).clone() for x in
                                          state.master])
            out[f"{kind}_step_s"] = secs
            out[f"{kind}_losses"] = losses
            del state, step_fn, model
        finally:
            clear_logical_rules()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    (lp, np_, mp), (ls, ns, ms) = runs["plain"], runs["sharded"]
    diffs = [float((a.double() - b.double()).abs().max())
             for a, b in zip(mp, ms)]
    out.update(loss_equal=lp == ls, norm_equal=np_ == ns,
               master_equal=all(torch.equal(a, b) for a, b in zip(mp, ms)),
               master_max_diff=max(diffs), params=sum(x.numel() for x in mp))
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    return out


def _moe(rank_mesh, kw: dict) -> dict:
    """``"moe"``: a model's logits (and, with ``backward``, its gradients)
    under ``dispatch`` over a mesh, ``runs`` times; rank 0 returns the
    logits, every rank whether its runs agreed bit for bit."""
    import dataclasses as dc

    from repro_torch.training import train_step as ts_mod

    dev = rank_mesh.device
    mesh = _mesh(rank_mesh, kw["shape"], kw.get("axes",
                                                      ("data", "model")))
    use_logical_rules(mesh, ("data",))
    try:
        out = {}
        tokens = torch.from_numpy(np.asarray(kw["tokens"]))
        for disp in kw["dispatch"]:
            cfg = dc.replace(kw["cfg"], moe_dispatch=disp)
            model = _build_model(cfg, dev, kw.get("init"), False)
            shard_model(model, mesh, source=kw.get("source"))
            batch = shard_batch({"tokens": tokens}, mesh)
            runs = []
            for _ in range(kw.get("runs", 1)):
                with mesh_ops(model):
                    if kw.get("backward"):
                        model.requires_grad_(True)
                        logits, aux = model.forward_train(batch)
                        loss = ts_mod.cross_entropy(
                            logits[:, :-1], batch["tokens"][:, 1:]) + aux
                        grads = torch.autograd.grad(
                            loss, list(model.parameters()))
                        runs.append([local(logits).detach().clone()] +
                                    [local(g).clone() for g in grads])
                    else:
                        with torch.no_grad():
                            logits, _ = model.forward_train(batch)
                        runs.append([local(logits).clone()])
            out[f"{disp}_replay_bitwise"] = all(
                all(torch.equal(a, b) for a, b in zip(runs[0], r))
                for r in runs[1:])
            full_logits = full(logits).detach()
            if rank_mesh.rank == 0:
                out[disp] = full_logits.cpu().numpy()
            del model, runs, logits, full_logits
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
        return out
    finally:
        clear_logical_rules()


def _moe_layer(rank_mesh, kw: dict) -> dict:
    """``"moe_layer"``: one MoE layer's ``moe_ffn`` under ``dispatch`` over
    a mesh, on a global (B, S, d) input; rank 0 returns the output."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models import moe
    from repro_torch.models.layers import Init

    dev = rank_mesh.device
    mesh = _mesh(rank_mesh, kw["shape"], kw.get("axes",
                                                      ("data", "model")))
    use_logical_rules(mesh, ("data",))
    try:
        d, f, e = kw["dims"]
        layer = moe.MoE(Init(dev, None), d, f, e)
        for name, p in layer.named_parameters():
            rule = ("ep", None, None) if p.dim() == 3 else (None, None)
            spec = tuple("model" if r == "ep" and p.shape[0] %
                         mesh.size(1) == 0 else None for r in rule)
            setattr(layer, name, nn.Parameter(place(
                torch.from_numpy(np.asarray(kw["params"][name])), mesh,
                spec_placements(mesh, spec)), requires_grad=False))
        x = place(torch.from_numpy(np.asarray(kw["x"])), mesh,
                  spec_placements(mesh, (("data",),)))
        with layers_mod.replicated_constants(), torch.no_grad():
            out, aux = moe.moe_ffn(layer, x, num_experts=e,
                                   top_k=kw["top_k"],
                                   capacity_factor=kw["capacity_factor"],
                                   dispatch=kw["dispatch"])
        out = out.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        aux = float(full(aux))
        return (dict(out=out.cpu().numpy(), aux=aux)
                if rank_mesh.rank == 0 else {})
    finally:
        clear_logical_rules()


def _checkpoint(rank_mesh, kw: dict) -> dict:
    """``"ckpt"``: the JAX package's elastic case (an (8, 8) arange saved
    from a (world,) mesh, restored onto ``arange_shape``) and a
    ``TrainState`` saved from one mesh and resumed onto another."""
    from repro_torch import convert
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training import elastic
    from repro_torch.training import train_step as ts_mod

    out = {}
    world = rank_mesh.world
    mesh1 = _mesh(rank_mesh, (world,), ("data",))
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ckpt_mod.save(kw["arange_dir"], 1, {"w": place(
        w, mesh1, spec_placements(mesh1, ("data", None)))})
    mesh2 = _mesh(rank_mesh, kw["arange_shape"])
    got = ckpt_mod.restore(kw["arange_dir"], 1, {"w": w}, shardings={
        "w": NamedSharding(mesh2, ("data", "model"))})["w"]
    out["arange_equal"] = bool(torch.equal(full(got).cpu(), w))
    out["arange_placements"] = str(got.placements)
    # A train state: saved sharded on ``save_shape``; then resumed onto
    # ``restore_shape`` by ``elastic.resume_or_init(..., shardings=)``.
    cfg = kw["cfg"]
    for tag, shape in (("save", kw["save_shape"]),
                       ("restore", kw["restore_shape"])):
        mesh = _mesh(rank_mesh, shape)
        model = _build_model(cfg, rank_mesh.device,
                             kw["init"] if tag == "save" else None, False)
        shard = param_shardings(model, mesh)
        shardings = (shard, opt_state_shardings(None, shard, mesh))
        state = ts_mod.init_train_state(model)
        if tag == "save":
            convert.load_train_state(state, kw["state"])
            ckpt_mod.save(kw["state_dir"], 2, distribute_train_state(
                state, shardings))
        else:
            state, step = elastic.resume_or_init(
                elastic.ElasticConfig(ckpt_dir=kw["state_dir"]),
                lambda: state, shardings=shardings)
            arrays = convert.train_state_to_arrays(state)
            if rank_mesh.rank == 0:
                out.update(restored=arrays, restored_step=step)
    return out


def run_plan(rank_mesh, plan: list) -> dict:
    """Run each step of ``plan`` (``(name, kind, kwargs)`` entries) on this
    rank and return host results by name (gloo ranks on a card stage
    DTensor's collectives through the host:
    :func:`stage_collectives_through_host`):

      * ``"train"``: a model (``init``: a seed, a JAX parameter tree, or
        None with ``source`` full tensors by name) placed on a mesh of
        ``shape`` by :func:`shard_model`, ``init_train_state``,
        optionally ``restore`` = (dir, step), then ``make_train_step``
        over ``batches`` (global numpy batches, sharded over ``data``),
        ``save`` = {step: dir} after those steps. With ``ref_grads`` (full
        tensors by name) the first batch's gradients are held to them
        first; with ``ref_master`` the final masters. It returns the
        losses, grad norms, this rank's state bytes, the seconds and
        collectives (as ``CommDebugMode`` counts them) of the steps, the
        peak device bytes, and with ``return_state`` the final state as
        JAX's tree;
      * ``"plain_vs_sharded"``: :func:`_plain_vs_sharded`;
      * ``"moe"``: :func:`_moe`; ``"moe_layer"``: :func:`_moe_layer`;
      * ``"ckpt"``: :func:`_checkpoint`.
    """
    import logging

    import torch.distributed as dist

    kinds = {"train": _train, "plain_vs_sharded": _plain_vs_sharded,
             "moe": _moe, "moe_layer": _moe_layer, "ckpt": _checkpoint}
    if (rank_mesh.device.type == "cuda"
            and dist.get_backend(rank_mesh.group) == "gloo"):
        stage_collectives_through_host()
    # DTensor warns at every two-axis reduction that it issues one
    # collective a mesh dim; the counts are read from CommDebugMode.
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    out = {}
    for name, kind, kw in plan:
        out[name] = kinds[kind](rank_mesh, kw)
    return out


__all__ = ["activation_rules", "use_logical_rules", "clear_logical_rules",
           "param_pspec", "param_shardings", "opt_state_shardings",
           "NamedSharding", "place", "shard_model", "distribute_train_state",
           "shard_batch", "run_plan"]

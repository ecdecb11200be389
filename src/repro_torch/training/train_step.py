"""The training step: loss, gradients, update, with microbatching, gradient
compression and remat, on one device or over a mesh.

The port of ``repro/training/train_step.py``. The JAX package keeps float32
parameters and casts the leaves of rank above 1 to bfloat16 on every
forward, so its AdamW updates float32 masters with float32 gradients that
hold bfloat16 values. The port's model holds those leaves in bfloat16
(``models/model.py``); :class:`TrainState` keeps a float32 master beside
each of them, AdamW updates the masters, and the model's bfloat16 copies
are refreshed from them after every update, rounded to nearest even as
``astype`` rounds. The forward then sees ``bf16(master)``, as in JAX. A
float32 leaf is its own master.

Microbatches are contiguous row blocks of the batch (JAX's
``_split_microbatches``); each one's gradients come from
``torch.autograd.grad`` and are summed into float32 buffers, as JAX's scan
sums them, never into a bfloat16 ``.grad``. The metrics (``loss``,
``grad_norm``, ``lr``, and ``aux`` without microbatching) stay tensors on
the device.

The same step runs on a state placed over a ``DeviceMesh``
(``training/sharding.py``'s ``distribute_train_state`` or ``shard_model``
before ``init_train_state``), with a batch of DTensors sharded over the
batch axes (``sharding.shard_batch``), as JAX jits the same step with
``in_shardings``. The gradients then come back as DTensors in the stored
placements; the global norm and the int8 scale are taken over each whole
leaf (a collective), never over a rank's block, and the elementwise AdamW
update runs on each rank's blocks. Microbatch i is the rows
[i*B/m, (i+1)*B/m) of the global batch, sharded over the batch axes again,
never a slice of each rank's rows: with MoE that would change which tokens
compete for capacity. The metrics come back as plain tensors.
``pod_axis`` names the mesh's pure data-parallel axis, as in the JAX
package; the gradient reduction over it is part of the stored placements'
reduce-scatter.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from repro_torch.models import Model
from repro_torch.models.layers import is_dtensor
from repro_torch.models.model import jax_leaf, jax_rank
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import sharding
from repro_torch.training.compression import compress_decompress, int8_scale


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The optimizer, gradient accumulation, z-loss and compression."""

    optimizer: opt_mod.OptimizerConfig = opt_mod.OptimizerConfig()
    microbatches: int = 1  # grad accumulation steps per update
    z_loss: float = 1e-4
    grad_compression: str = "none"  # none | bf16 | int8 (cross-pod reduce)
    pod_axis: Optional[str] = None  # set when a pod axis exists in the mesh


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step: the model (its
    compute copies), each parameter's float32 master, the parameters' names
    and JAX leaf ranks (``named_parameters`` order), and the optimizer
    state. ``master[i]`` is ``params[i]`` itself (detached) when that
    parameter is float32."""

    model: Model
    names: List[str]
    params: List[torch.Tensor]
    master: List[torch.Tensor]
    ranks: List[int]
    opt: opt_mod.OptState

    @property
    def device(self) -> torch.device:
        """The device that holds the state (this rank's, under a mesh)."""
        return self.model.device

    @property
    def mesh(self):
        """The ``DeviceMesh`` the state is placed over, or None."""
        p = self.params[0]
        return p.device_mesh if is_dtensor(p) else None

    def refresh(self) -> None:
        """Copy the masters into the lower-precision compute copies (each
        rank its own blocks)."""
        with torch.no_grad():
            for p, m in zip(self.params, self.master):
                if p.dtype != m.dtype:
                    sharding.local(p).copy_(sharding.local(m))


def init_train_state(model: Model) -> TrainState:
    """Turn on ``model``'s gradients and build its step-0 state: float32
    masters of its bfloat16 parameters (their values as they are) and zero
    moments."""
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    master = [p.detach() if p.dtype == torch.float32
              else p.detach().to(torch.float32) for p in params]
    return TrainState(model=model, names=list(names), params=list(params),
                      master=master,
                      ranks=[jax_rank(n, p) for n, p in zip(names, params)],
                      opt=opt_mod.init_opt_state(master))


def _token_nll(logits, labels, z_loss: float):
    """(B, S) per-token CE (+ z-loss) in float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return nll


def _token_nll_local(logits, labels, z_loss: float):
    """:func:`_token_nll` of DTensor logits, as an explicit step on local
    tensors: the vocab axis is gathered first (the label gather over a
    vocab-sharded DTensor is a masked partial that fails for (B, S, V)
    inputs, and the card's torch 2.11 fails to place the gather's
    backward), then each rank takes its own rows. Returns a DTensor placed
    as the rows are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, v = logits.device_mesh, logits.dim() - 1
    rows = [Replicate() if pl.is_partial() or (isinstance(pl, Shard)
                                               and pl.dim == v) else pl
            for pl in logits.placements]
    local = logits.redistribute(mesh, rows).to_local()
    ids = labels.to_local() if is_dtensor(labels) else labels
    return DTensor.from_local(_token_nll(local, ids, z_loss), mesh, rows)


def cross_entropy(logits, labels, mask=None, z_loss: float = 0.0):
    """Token-mean CE (+ z-loss). logits (B,S,V) f32/bf16, labels (B,S).
    Under a mesh the result is a replicated DTensor scalar."""
    if not is_dtensor(logits):
        nll = _token_nll(logits, labels, z_loss)
    else:
        nll = _token_nll_local(logits, labels, z_loss)
    if mask is None:
        loss = torch.mean(nll)
    else:
        mask = mask.to(torch.float32)
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if is_dtensor(loss):
        from torch.distributed.tensor import Replicate

        loss = loss.redistribute(loss.device_mesh,
                                 [Replicate()] * loss.device_mesh.ndim)
    return loss


def make_loss_fn(model: Model, tcfg: TrainConfig) -> Callable:
    """``loss_fn(batch) -> (loss, {"ce": loss, "aux": aux})``; the loss
    adds ``aux_loss_weight * aux`` for an MoE model."""
    cfg = model.cfg

    def loss_fn(batch):
        logits, aux = model.forward_train(batch)
        loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                             tcfg.z_loss)
        if cfg.num_experts:
            loss = loss + cfg.aux_loss_weight * aux
        return loss, {"ce": loss, "aux": aux}

    return loss_fn


def _split_microbatches(batch: dict, n: int) -> list:
    """``n`` contiguous row blocks of every array of ``batch``; a DTensor's
    blocks are rows of its global value, each placed as it was."""
    split = {k: sharding.full(v) for k, v in batch.items()}
    split = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
             for k, v in split.items()}
    return [{k: (sharding.place(v[i], batch[k].device_mesh,
                                batch[k].placements)
                 if is_dtensor(batch[k]) else v[i])
             for k, v in split.items()} for i in range(n)]


def _local_map(fn, g):
    """``fn`` over a DTensor's block (placed as ``g`` was), or over ``g``."""
    if not is_dtensor(g):
        return fn(g)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(fn(g.to_local()), g.device_mesh, g.placements,
                              shape=g.shape, stride=g.stride())


def _compress(state: TrainState, grads: list, method: str) -> list:
    """``compress_decompress`` over JAX's leaves: the parameters of one
    stacked leaf share one int8 scale, the largest magnitude over the whole
    leaf (over every rank's blocks under a mesh), as the JAX package's
    scale of the stacked leaf; the values are quantized elementwise."""
    groups = {}
    for i, name in enumerate(state.names):
        groups.setdefault(jax_leaf(name)[0], []).append(i)
    out = list(grads)
    for idx in groups.values():
        if state.ranks[idx[0]] == 0:  # a scalar leaf passes as it is
            continue
        scale = None
        if method == "int8":
            scale = int8_scale(torch.stack([sharding.full(
                torch.max(torch.abs(grads[i].to(torch.float32))))
                for i in idx]))
        for i in idx:
            out[i] = _local_map(lambda g: compress_decompress(
                g.to(torch.float32), method, scale=scale), grads[i])
    return out


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    (built by :func:`init_train_state` on ``model``) is updated in place."""
    loss_fn = make_loss_fn(model, tcfg)

    def grads_of(state, loss):
        return torch.autograd.grad(loss, state.params, allow_unused=True,
                                   materialize_grads=True)

    def train_step(state: TrainState, batch: dict):
        with sharding.mesh_ops(state):
            return step(state, batch)

    def step(state: TrainState, batch: dict):
        n = tcfg.microbatches
        if n > 1:
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in state.params]
            lsum = torch.zeros((), dtype=torch.float32, device=state.device)
            for mb in _split_microbatches(batch, n):
                loss, _ = loss_fn(mb)
                for a, g in zip(gsum, grads_of(state, loss)):
                    a.add_(g)
                lsum = lsum + sharding.full(loss.detach())
            grads = [g.div_(n) for g in gsum]
            loss = lsum / n
            extra = {}
        else:
            loss, extra = loss_fn(batch)
            grads = grads_of(state, loss)
            loss = sharding.full(loss.detach())
        if tcfg.grad_compression != "none":
            grads = _compress(state, grads, tcfg.grad_compression)
        with torch.no_grad():
            _, state.opt, metrics = opt_mod.adamw_update(
                tcfg.optimizer, state.master, grads, state.opt, state.ranks)
        del grads
        state.refresh()
        metrics = dict(metrics, loss=loss)
        metrics.update({k: sharding.full(v.detach())
                        for k, v in extra.items() if k != "ce"})
        return state, metrics

    return train_step


def make_eval_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``eval_step(batch) -> loss`` over the model as it stands."""
    loss_fn = make_loss_fn(model, tcfg)

    def eval_step(batch):
        with torch.no_grad(), sharding.mesh_ops(model):
            loss, _ = loss_fn(batch)
        return sharding.full(loss)

    return eval_step

"""The training step: loss, gradients, update, with microbatching, gradient
compression and remat, on one device.

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
the device. ``TrainConfig`` has no ``pod_axis``: that belongs to the
sharded step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from repro_torch.models import Model
from repro_torch.models.model import jax_leaf, jax_rank
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.compression import compress_decompress


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The optimizer, gradient accumulation, z-loss and compression."""

    optimizer: opt_mod.OptimizerConfig = opt_mod.OptimizerConfig()
    microbatches: int = 1  # grad accumulation steps per update
    z_loss: float = 1e-4
    grad_compression: str = "none"  # none | bf16 | int8


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
        """The device that holds the state."""
        return self.model.device

    def refresh(self) -> None:
        """Copy the masters into the lower-precision compute copies."""
        with torch.no_grad():
            for p, m in zip(self.params, self.master):
                if p.dtype != m.dtype:
                    p.copy_(m)


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


def cross_entropy(logits, labels, mask=None, z_loss: float = 0.0):
    """Token-mean CE (+ z-loss). logits (B,S,V) f32/bf16, labels (B,S)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


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
    """``n`` contiguous row blocks of every array of ``batch``."""
    split = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
             for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _compress(state: TrainState, grads: list, method: str) -> list:
    """``compress_decompress`` over JAX's leaves: the parameters of one
    stacked leaf are stacked, compressed together and taken apart."""
    groups = {}
    for i, name in enumerate(state.names):
        groups.setdefault(jax_leaf(name)[0], []).append(i)
    out = list(grads)
    for idx in groups.values():
        leaf = torch.stack([grads[i].to(torch.float32) for i in idx])
        for i, g in zip(idx, compress_decompress(leaf, method).unbind(0)):
            out[i] = g
    return out


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    (built by :func:`init_train_state` on ``model``) is updated in place."""
    loss_fn = make_loss_fn(model, tcfg)

    def grads_of(state, loss):
        return torch.autograd.grad(loss, state.params, allow_unused=True,
                                   materialize_grads=True)

    def train_step(state: TrainState, batch: dict):
        n = tcfg.microbatches
        if n > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in state.params]
            lsum = torch.zeros((), dtype=torch.float32, device=state.device)
            for mb in _split_microbatches(batch, n):
                loss, _ = loss_fn(mb)
                for a, g in zip(gsum, grads_of(state, loss)):
                    a.add_(g)
                lsum = lsum + loss.detach()
            grads = [g.div_(n) for g in gsum]
            loss = lsum / n
            extra = {}
        else:
            loss, extra = loss_fn(batch)
            grads = grads_of(state, loss)
            loss = loss.detach()
        if tcfg.grad_compression != "none":
            grads = _compress(state, grads, tcfg.grad_compression)
        with torch.no_grad():
            _, state.opt, metrics = opt_mod.adamw_update(
                tcfg.optimizer, state.master, grads, state.opt, state.ranks)
        del grads
        state.refresh()
        metrics = dict(metrics, loss=loss)
        metrics.update({k: v.detach() for k, v in extra.items()
                        if k != "ce"})
        return state, metrics

    return train_step


def make_eval_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``eval_step(batch) -> loss`` over the model as it stands."""
    loss_fn = make_loss_fn(model, tcfg)

    def eval_step(batch):
        with torch.no_grad():
            loss, _ = loss_fn(batch)
        return loss

    return eval_step

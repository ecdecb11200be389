"""AdamW with cosine schedule, global-norm clipping, and weight decay.

The port of ``repro/training/optimizer.py``, op for op as the JAX package
computes it (no ``torch.optim``: its op order and per-group decay are not
this function). The state is a list of float32 moments aligned with the
list of parameters it updates; the step is an int32 tensor on the
parameters' device, and the schedule and bias corrections are float32
tensors computed from it there, so an update never waits on the host.

Over a mesh the parameters, gradients and moments are DTensors in the
same placements: the global norm sums each whole leaf (a collective), and
the elementwise update runs on each rank's blocks with plain scalars.

Weight decay applies to matrices only, by the rank of each parameter's leaf
in the JAX package's stacked tree: a per-layer norm scale under ``blocks``
is a (L, d) leaf there, so it is decayed, while ``final_norm``'s is not.
:func:`adamw_update` takes those ranks (``models.model.jax_rank``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch.training.sharding import full, local


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW's hyperparameters and the warmup-then-cosine schedule."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    """The optimizer's state: the int32 step and the float32 moments, one
    per parameter (JAX's field names, so a checkpoint names them alike)."""

    step: torch.Tensor
    mu: List[torch.Tensor]  # first moment, like params
    nu: List[torch.Tensor]  # second moment, like params


def init_opt_state(params: Sequence[torch.Tensor]) -> OptState:
    """Step 0 and zero moments shaped like ``params``."""
    dev = params[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        nu=[torch.zeros_like(p, dtype=torch.float32) for p in params])


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor): linear warmup, then a
    cosine decay to ``min_lr_ratio`` of the peak, as a float32 tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * (cfg.min_lr_ratio
                                       + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32 (of every
    rank's blocks, for DTensors)."""
    sums = [full(torch.sum(torch.square(x.to(torch.float32))))
            for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale for g in grads], norm


def adamw_update(cfg: OptimizerConfig, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: OptState,
                 ranks: Optional[Sequence[int]] = None):
    """One AdamW step. Updates ``params`` and the moments in place and
    returns (params, the new ``OptState``, metrics: ``grad_norm``, ``lr``).

    ``params`` are float32 (the masters of a bfloat16 model); ``grads`` of
    any float dtype, upcast to float32 first. ``ranks[i]`` is parameter i's
    rank in JAX's tree (default: its own ndim); matrices (rank >= 2) decay.
    """
    if ranks is None:
        ranks = [p.dim() for p in params]
    norm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    for p, g, m, v, rank in zip(params, grads, state.mu, state.nu, ranks):
        p, g, m, v = local(p), local(g), local(m), local(v)
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g) * (1 - cfg.b2))
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if rank >= 2:  # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * p)
        p.sub_(delta.mul_(lr))
    return params, OptState(step, state.mu, state.nu), {"grad_norm": norm,
                                                        "lr": lr}

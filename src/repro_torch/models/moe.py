"""Mixture-of-Experts layer: top-k routing, capacity-bounded sort-based
dispatch (no giant one-hot), shared experts (DeepSeek-MoE).

The port of ``repro/models/moe.py``'s global dispatch: flatten the (token,
k) assignments, stable-sort them by expert id, rank each within its expert
segment, and scatter into a fixed (E, C, d) buffer. Assignments whose rank
reaches the capacity C = max(int(k * T * cf / E), 4) are dropped. The
expert FFNs run as one batched einsum over the buffer.

Routing keeps the JAX package's order: ``lax.top_k`` breaks ties toward
the lower expert index, so the top k come from a stable descending sort
(``torch.topk`` promises no tie order), and the dispatch sort is stable.
The JAX package's ``dispatch="local"`` means something only under a mesh;
without one it takes this global path too, so that is the path here.
The combine scatter-adds a token's k contributions (``index_add_``),
whose order on a card is not fixed: hold card results within a tolerance.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.layers import Init


class MoE(nn.Module):
    """A routed MoE layer's parameters: the router, the stacked experts'
    SwiGLU weights and, where configured, the shared experts' MLP."""

    def __init__(self, init: Init, d_model: int, d_ff_expert: int,
                 num_experts: int, num_shared_experts: int = 0,
                 d_ff_shared=None):
        super().__init__()
        self.router = init.dense((d_model, num_experts), scale=0.02)
        self.wi_gate = init.dense((num_experts, d_model, d_ff_expert))
        self.wi_up = init.dense((num_experts, d_model, d_ff_expert))
        self.wo = init.dense((num_experts, d_ff_expert, d_model))
        if num_shared_experts:
            d_sh = d_ff_shared or d_ff_expert * num_shared_experts
            self.shared = layers.MLP(init, d_model, d_sh, "swiglu")


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values descending, ties toward
    the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_core(p, x, *, num_experts: int, top_k: int,
              capacity_factor: float, renormalize: bool):
    """Routed-experts pass on (B, S, d); returns (out, aux). No shared
    experts here (they are dense and live outside the dispatch)."""
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    logits = (xf @ p.router).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, top_k)  # (T, k)
    if renormalize:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    capacity = max(int(top_k * t * capacity_factor / num_experts), 4)

    # ---- sort-based dispatch: rank of each assignment within its expert ----
    e_flat = expert_idx.reshape(-1)  # (T*k,)
    t_flat = torch.arange(t, device=dev).repeat_interleave(top_k)
    g_flat = gate_vals.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    seg_start = torch.searchsorted(
        e_sorted, torch.arange(num_experts, device=dev), side="left")
    rank_sorted = torch.arange(t * top_k, device=dev) - seg_start[e_sorted]
    keep = rank_sorted < capacity
    slot = torch.where(keep, e_sorted * capacity + rank_sorted, 0)

    # Scatter token states into the (E*C, d) dispatch buffer.
    tok_sorted = t_flat[order]
    src = xf[tok_sorted] * keep[:, None].to(xf.dtype)
    buf = torch.zeros((num_experts * capacity, d), dtype=xf.dtype,
                      device=dev)
    buf.index_add_(0, slot, src)  # unique slots (add = copy; 0 for dropped)
    buf = buf.reshape(num_experts, capacity, d)

    # ---- expert FFN (batched over E) ----
    h = layers.silu(torch.einsum("ecd,edf->ecf", buf, p.wi_gate)) * \
        torch.einsum("ecd,edf->ecf", buf, p.wi_up)
    out_buf = torch.einsum("ecf,efd->ecd", h, p.wo)

    # ---- combine: gather each surviving assignment, weight, segment-sum ----
    out_flat = out_buf.reshape(num_experts * capacity, d)
    gathered = out_flat[slot]
    gathered = gathered * (g_flat[order] * keep)[:, None].to(gathered.dtype)
    out = torch.zeros((t, d), dtype=gathered.dtype, device=dev)
    out.index_add_(0, tok_sorted, gathered)

    # Load-balance auxiliary loss (Switch-style: E * sum(frac_i * prob_i)).
    me = probs.mean(dim=0)  # (E,)
    ce = torch.zeros(num_experts, device=dev).index_add_(
        0, e_flat, torch.ones(e_flat.shape, device=dev)) / (t * top_k)
    aux = num_experts * torch.sum(me * ce)
    return out.reshape(b, s, d), aux


def moe_ffn(p, x, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, renormalize: bool = True):
    """x: (B, S, d) -> (B, S, d). Returns (out, aux)."""
    out, aux = _moe_core(p, x, num_experts=num_experts, top_k=top_k,
                         capacity_factor=capacity_factor,
                         renormalize=renormalize)
    if hasattr(p, "shared"):  # dense shared experts
        out = out + layers.mlp(p.shared, x, "swiglu")
    return out, aux

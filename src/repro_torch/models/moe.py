"""Mixture-of-Experts layer: top-k routing, capacity-bounded sort-based
dispatch (no giant one-hot), shared experts (DeepSeek-MoE), EP-shardable.

The port of ``repro/models/moe.py``: flatten the (token, k) assignments,
stable-sort them by expert id, rank each within its expert segment, and
scatter into a fixed (E, C, d) buffer. Assignments whose rank reaches the
capacity C = max(int(k * T * cf / E), 4) are dropped. The expert FFNs run
as one batched einsum over the buffer.

Routing keeps the JAX package's order: ``lax.top_k`` breaks ties toward
the lower expert index, so the top k come from a stable descending sort
(``torch.topk`` promises no tie order), and the dispatch sort is stable.

The combine is deterministic on a card too. A token's k contributions are
summed left to right in the order of their positions in the stable expert
sort (the order in which the CPU's ``index_add_`` adds them, so the CPU
results are the same bits as a scatter-add's), never by atomics. Dropped
assignments read an appended zero row, so every other buffer row is
gathered at most once and the gather's backward writes each row's gradient
once; the token gather of the dispatch is an expand, whose backward is a
fixed-order sum. Forward and backward are bitwise replayable.

Two dispatch scopes (``ModelConfig.moe_dispatch``), as in the JAX package
(``repro/models/moe.py:114-156``). They differ only under a mesh
(``layers.set_logical_rules`` with a ``DeviceMesh``, the activations
DTensors): routing, dispatch and combine run on each rank's local tensors
in an explicit step, because DTensor has no sharding strategy for
``searchsorted`` and the sort-based dispatch is local work anyway.

  * ``"local"``: one group per shard of the batch axes; a rank routes its
    own rows with a per-shard capacity (the JAX package's grouped vmap).
  * ``"global"``: every rank gathers all rows over the batch axes and
    routes them together with the global capacity, then keeps its rows.

In both, the expert FFNs run over a (groups, E, C, d) DTensor buffer, each
rank on its own experts' slice, so the experts stay sharded over ``model``
(EP, the ``("ep", None, None)`` rule of ``training/sharding.py``; the
buffer's explicit placements stand for the JAX package's annotations at
its ``:89, :96, :98``). Without a mesh both are the global path on plain
tensors.
"""

from __future__ import annotations

import math

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


def _route(router, xf, *, num_experts: int, top_k: int,
           capacity_factor: float, renormalize: bool) -> dict:
    """Routing and the sort-based dispatch of the (T, d) rows ``xf``.

    Returns the (E, C, d) buffer and what the combine needs: ``slot``
    (each sorted assignment's buffer row, E*C for a dropped one), ``keep``,
    the sorted gate values, ``pos`` (each token's k positions in the sort,
    ascending), the probabilities and the flat expert ids."""
    t, d = xf.shape
    dev = xf.device
    logits = (xf @ router).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, top_k)  # (T, k)
    if renormalize:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    capacity = max(int(top_k * t * capacity_factor / num_experts), 4)

    # ---- sort-based dispatch: rank of each assignment within its expert ----
    e_flat = expert_idx.reshape(-1)  # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    seg_start = torch.searchsorted(
        e_sorted, torch.arange(num_experts, device=dev), side="left")
    rank_sorted = torch.arange(t * top_k, device=dev) - seg_start[e_sorted]
    keep = rank_sorted < capacity
    slot = torch.where(keep, e_sorted * capacity + rank_sorted, 0)

    # Scatter token states into the (E*C, d) dispatch buffer. The token
    # rows come from an expand (token t repeated k times, then permuted):
    # its backward sums a token's k gradients in a fixed order.
    src = xf[:, None, :].expand(t, top_k, d).reshape(t * top_k, d)[order]
    src = src * keep[:, None].to(xf.dtype)
    buf = torch.zeros((num_experts * capacity, d), dtype=xf.dtype,
                      device=dev)
    buf.index_add_(0, slot, src)  # unique slots (add = copy; 0 for dropped)
    # Each token's k positions in the sort, ascending: the combine's order.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * top_k, device=dev)
    pos = torch.sort(inv.reshape(t, top_k), dim=1).values
    return dict(buf=buf.reshape(num_experts, capacity, d),
                slot=torch.where(keep, slot, num_experts * capacity),
                keep=keep, gates=gate_vals.reshape(-1)[order], pos=pos,
                probs=probs, e_flat=e_flat)


def _experts(p, buf):
    """The expert FFNs over an (E, C, d) buffer: SwiGLU, batched over E."""
    buf = layers.logical(buf, "expert", None, "embed")
    h = layers.silu(torch.einsum("ecd,edf->ecf", buf, p.wi_gate)) * \
        torch.einsum("ecd,edf->ecf", buf, p.wi_up)
    # The expert dim already holds the model axis (EP); the per-expert ffn
    # dim stays unsharded: "expert" + "mlp" would map the axis twice.
    h = layers.logical(h, "expert", None, None)
    out = torch.einsum("ecf,efd->ecd", h, p.wo)
    return layers.logical(out, "expert", None, "embed")


def _experts_mesh(p, buf):
    """:func:`_experts` of a (groups, E, C, d) DTensor buffer, each rank
    running the einsums on its own experts' slice (the mesh dims on which
    the expert weights are sharded, EP) as an explicit local step: the
    card's torch 2.11 cannot place the einsums' flattening views. The
    buffer's slice and the outputs' gather are DTensor redistributions, so
    their gradients are exact; a weight's local gradient is a partial sum
    over the dims the groups are sharded on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = buf.device_mesh
    ep = {i for i, pl in enumerate(p.wi_gate.placements)
          if isinstance(pl, Shard) and pl.dim == 0}
    placed = [Shard(1) if i in ep else pl
              for i, pl in enumerate(buf.placements)]
    grads = [Shard(0) if i in ep else
             (Partial() if isinstance(pl, Shard) else Replicate())
             for i, pl in enumerate(buf.placements)]
    b = layers.contiguous_grad(buf.redistribute(mesh, placed).to_local())
    wg, wu, wo = (getattr(p, n).redistribute(mesh, [
        Shard(0) if i in ep else Replicate() for i in range(mesh.ndim)])
        .to_local(grad_placements=grads)
        for n in ("wi_gate", "wi_up", "wo"))
    h = layers.silu(torch.einsum("gecd,edf->gecf", b, wg)) * \
        torch.einsum("gecd,edf->gecf", b, wu)
    out = torch.einsum("gecf,efd->gecd", h, wo)
    return DTensor.from_local(out.contiguous(), mesh, placed)


def _combine(r: dict, out_buf, t: int):
    """Weight each surviving assignment and sum a token's k contributions
    left to right in sort order: (T, d)."""
    e, c, d = out_buf.shape
    # Dropped assignments read the appended zero row E*C.
    out_flat = torch.cat([out_buf.reshape(e * c, d), out_buf.new_zeros(1, d)])
    gathered = out_flat[r["slot"]]
    gathered = gathered * (r["gates"] * r["keep"])[:, None].to(
        gathered.dtype)
    parts = gathered[r["pos"]]  # (T, k, d)
    out = torch.zeros((t, d), dtype=gathered.dtype, device=gathered.device)
    for j in range(parts.shape[1]):
        out = out + parts[:, j]
    return out


def _aux(r: dict, num_experts: int, top_k: int):
    """Load-balance auxiliary loss (Switch-style: E * sum(frac_i * prob_i))."""
    probs, e_flat = r["probs"], r["e_flat"]
    t = probs.shape[0]
    me = probs.mean(dim=0)  # (E,)
    ce = torch.zeros(num_experts, device=probs.device).index_add_(
        0, e_flat, torch.ones(e_flat.shape, device=probs.device)) / (t * top_k)
    return num_experts * torch.sum(me * ce)


def _moe_core(p, x, *, num_experts: int, top_k: int,
              capacity_factor: float, renormalize: bool):
    """Routed-experts pass on (B, S, d); returns (out, aux). No shared
    experts here (they are dense and live outside the dispatch)."""
    b, s, d = x.shape
    r = _route(p.router, x.reshape(b * s, d), num_experts=num_experts,
               top_k=top_k, capacity_factor=capacity_factor,
               renormalize=renormalize)
    out_buf = _experts(p, r["buf"])
    out = _combine(r, out_buf, b * s)
    return out.reshape(b, s, d), _aux(r, num_experts, top_k)


def _moe_mesh(p, x, mesh, rules, *, local: bool, **kw):
    """The routed experts of a DTensor ``x`` under ``mesh``: routing,
    dispatch and combine on each rank's local rows (``local``: its own
    group; else every row, gathered over the batch axes), the expert
    einsums as DTensor ops with the experts sharded over ``model``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = mesh.mesh_dim_names
    batch = tuple(a for a in (rules.get("batch") or ())
                  if a in names and mesh.size(names.index(a)) > 1)
    # Where a group's rows live: sharded over the batch axes (local), or
    # replicated everywhere (global).
    grouped = [Shard(0) if (local and n in batch) else Replicate()
               for n in names]
    rep = [Replicate()] * len(names)
    b, s, d = x.shape
    xl = x.redistribute(mesh, grouped).to_local()
    # The router is replicated; its local gradient is this rank's rows'
    # share (a partial sum over the batch axes) or, global, the whole.
    router = p.router.redistribute(mesh, rep).to_local(grad_placements=[
        Partial() if (local and n in batch) else Replicate() for n in names])
    bl = xl.shape[0]
    r = _route(router, xl.reshape(bl * s, d), **kw)
    # The expert FFNs: a (groups, E, C, d) DTensor, one group a rank's row
    # block, against the experts as they are placed (EP over ``model``).
    buf = DTensor.from_local(r["buf"][None], mesh, grouped)
    out_buf = _experts_mesh(p, buf).redistribute(mesh, grouped).to_local()[0]
    out = _combine(r, out_buf, bl * s).reshape(bl, s, d)
    aux = _aux(r, kw["num_experts"], kw["top_k"])
    out = DTensor.from_local(out, mesh, grouped)
    aux = DTensor.from_local(aux[None], mesh, grouped).mean().redistribute(
        mesh, rep)
    # Each rank keeps its rows: the batch placement of ``x``.
    rows = [Shard(0) if n in batch else Replicate() for n in names]
    return out.redistribute(mesh, rows), aux


def moe_ffn(p, x, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, renormalize: bool = True,
            dispatch: str = "global"):
    """x: (B, S, d) -> (B, S, d). Returns (out, aux)."""
    kw = dict(num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor, renormalize=renormalize)
    mesh, rules = layers._ACTIVE_MESH, layers._LOGICAL_RULES
    if mesh is not None and rules and layers.is_dtensor(x):
        names = mesh.mesh_dim_names
        batch = [a for a in (rules.get("batch") or ())
                 if a in names and mesh.size(names.index(a)) > 1]
        groups = math.prod(mesh.size(names.index(a)) for a in batch)
        local = (dispatch == "local" and groups > 1
                 and x.shape[0] % groups == 0)
        out, aux = _moe_mesh(p, x, mesh, rules, local=local, **kw)
    else:
        out, aux = _moe_core(p, x, **kw)
    if hasattr(p, "shared"):  # dense shared experts
        out = out + layers.mlp(p.shared, x, "swiglu")
    return out, aux

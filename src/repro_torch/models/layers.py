"""Shared neural-net layers of the port's architecture zoo.

The port of ``repro/models/layers.py``. Each layer is an ``nn.Module`` that
owns its parameters under the JAX package's dict keys (``wq``, ``scale``,
``table`` ...), so ``convert.model_from_arrays`` maps a JAX parameter tree
onto it name for name, and a function ``f(p, x, ...)`` over that module,
written as the JAX function is: the same casts, the same masks, the same
online softmax.

Logical axis annotations (``logical``/``set_logical_rules``, the JAX
package's ``repro/models/layers.py:26-45``) sit at the JAX package's sites.
With no rules (one card, the default) ``logical`` returns its argument
untouched. With rules and a ``DeviceMesh`` (``training/sharding.py``'s
``use_logical_rules``) a DTensor activation is redistributed to the
placements the rules name for each of its axes: the port's
``with_sharding_constraint``. A dimension that the named mesh axes do not
divide stays replicated (GSPMD pads such a dimension; DTensor would shard
it unevenly).

Attention supports: causal / bidirectional, GQA/MQA (kv heads broadcast),
sliding-window masks (Gemma-3 local layers), RoPE and M-RoPE (Qwen2-VL),
dense or flash-style chunked evaluation (long prefill), and KV-cache decode
with a scalar or a per-row write position. It is written with
``torch.einsum`` as the JAX package writes it, not with
``F.scaled_dot_product_attention``, whose masking and rounding differ.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG = -1e30  # additive mask bias: a fully masked row softmaxes to uniform


# ---------------------------------------------------------------------------
# Logical axis annotations (resolved to mesh axes in training/sharding.py).
# ---------------------------------------------------------------------------

_LOGICAL_RULES = None  # set by training.sharding.use_logical_rules
_ACTIVE_MESH = None  # the DeviceMesh those rules refer to


def set_logical_rules(rules, mesh=None):
    """Install ``rules`` (logical axis name -> mesh axis name, a tuple of
    them, or None) over ``mesh``; ``None`` removes them."""
    global _LOGICAL_RULES, _ACTIVE_MESH
    _LOGICAL_RULES = rules
    _ACTIVE_MESH = mesh


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed over a ``DeviceMesh``)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@contextlib.contextmanager
def replicated_constants():
    """Inside this context plain tensors (positions, masks, the step) mix
    with DTensors as replicated ones. DTensor's own
    ``implicit_replication`` turns the flag off on exit even when it was
    on before; this one restores it, so it nests (remat recomputes a layer
    inside the train step's context)."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def logical(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Annotate activation x with logical axis names (no-op without rules):
    a DTensor is redistributed to the placements the rules name."""
    if _LOGICAL_RULES is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = _ACTIVE_MESH
    dims = mesh.mesh_dim_names
    placements = [Replicate()] * len(dims)
    for d, name in enumerate(names):
        axes = _LOGICAL_RULES.get(name) if name else None
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        axes = [a for a in axes if a in dims
                and mesh.size(dims.index(a)) > 1]
        if x.shape[d] % math.prod(mesh.size(dims.index(a))
                                  for a in axes) == 0:
            for a in axes:
                placements[dims.index(a)] = Shard(d)
    return x.redistribute(mesh, placements)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Init:
    """Where a module's parameters come from: normal draws from
    ``generator`` on ``device`` (float32), or, with no generator, empty
    tensors for a loader to fill (``convert.model_from_arrays``)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator]):
        self.device = device
        self.generator = generator

    def normal(self, shape, std: float) -> nn.Parameter:
        """A normal draw times ``std`` (empty when loading)."""
        if self.generator is None:
            return self.empty(shape)
        x = torch.randn(shape, generator=self.generator, device=self.device)
        return _param(x.mul_(std))

    def dense(self, shape, scale: Optional[float] = None) -> nn.Parameter:
        """``_dense_init``: normal times fan_in ** -0.5 (or ``scale``)."""
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        return self.normal(shape, scale if scale is not None
                           else fan_in ** -0.5)

    def full(self, shape, value: float) -> nn.Parameter:
        """A float32 tensor filled with ``value``."""
        return _param(torch.full(shape, value, dtype=torch.float32,
                                 device=self.device))

    def empty(self, shape) -> nn.Parameter:
        """An uninitialised float32 tensor for a loader to fill."""
        return _param(torch.empty(shape, dtype=torch.float32,
                                  device=self.device))


def _param(x: torch.Tensor) -> nn.Parameter:
    # Serving computes no gradient; ``training.init_train_state`` turns
    # gradients on for the model it trains.
    return nn.Parameter(x, requires_grad=False)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion of mixed float dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# Activations, op by op as ``jax.nn`` writes them. XLA rounds every
# elementwise op to bfloat16 in turn, while a fused torch activation
# (``F.silu``, ``F.gelu``) rounds once: in bfloat16 the two disagree in
# about a third of the elements. Each torch op here rounds as XLA's does.
# ---------------------------------------------------------------------------

def _const(value: float, x: torch.Tensor) -> torch.Tensor:
    """A Python constant as JAX makes it: rounded to ``x``'s dtype."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def silu(x):
    """``jax.nn.silu``: x * logistic(x), logistic = 1 / (1 + exp(-x))."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)``; x ** 3 as XLA's integer power."""
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * (x * x)))
    return x * (_const(0.5, x) * (1 + torch.tanh(inner)))


def softplus(x):
    """``jax.nn.softplus`` = logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


# ---------------------------------------------------------------------------
# RMSNorm / MLP
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """RMSNorm's parameters: ``scale`` (d,), ones at init."""

    def __init__(self, init: Init, d: int):
        super().__init__()
        self.scale = init.full((d,), 1.0)


def rmsnorm(p, x, eps=1e-5):
    """x / rms(x) * scale, computed in float32 and cast back."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p.scale).to(dt)


class MLP(nn.Module):
    """A feed-forward block's weights: gated (``wi_gate``, ``wi_up``) for
    swiglu/geglu, one ``wi`` for gelu/relu2, then ``wo``."""

    def __init__(self, init: Init, d_model: int, d_ff: int,
                 mlp_type: str = "swiglu"):
        super().__init__()
        if mlp_type in ("swiglu", "geglu"):
            self.wi_gate = init.dense((d_model, d_ff))
            self.wi_up = init.dense((d_model, d_ff))
        else:  # gelu / relu-squared
            self.wi = init.dense((d_model, d_ff))
        self.wo = init.dense((d_ff, d_model))


def mlp(p, x, mlp_type="swiglu"):
    """The feed-forward block of ``mlp_type`` (GELU is the tanh form)."""
    if mlp_type in ("swiglu", "geglu"):
        act = silu if mlp_type == "swiglu" else gelu_tanh
        h = act(x @ p.wi_gate) * (x @ p.wi_up)
        h = logical(h, "batch", "mlp_seq", "mlp")
        return h @ p.wo
    if mlp_type == "relu2":
        h = torch.square(F.relu(x @ p.wi))
    else:
        h = gelu_tanh(x @ p.wi)
    h = logical(h, "batch", "mlp_seq", "mlp")
    return h @ p.wo


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The (head_dim/2,) float32 rotary frequencies theta**(-2i/hd)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               mrope_sections: Optional[tuple] = None) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (B, S, 3) for M-RoPE.

    M-RoPE (Qwen2-VL): the rotary dimension is split into sections, each
    rotated by its own position stream (temporal / height / width). The
    rotation runs in float32 and is cast back to ``x``'s dtype.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    if positions.dim() == 3:  # M-RoPE
        if mrope_sections is None:
            mrope_sections = (hd // 2 - 2 * (hd // 6), hd // 6, hd // 6)
        sec = []
        start = 0
        for i, s in enumerate(mrope_sections):
            sec.append(positions[..., i: i + 1] * freqs[None, None,
                                                        start: start + s])
            start += s
        angles = torch.cat(sec, dim=-1)  # (B, S, hd/2)
    else:
        angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]  # (B, S, 1, hd/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, masks, flash-style chunking, KV-cache decode)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projections: ``wq`` (d, H*hd), ``wk``/``wv`` (d, K*hd),
    ``wo`` (H*hd, d)."""

    def __init__(self, init: Init, d_model: int, num_heads: int,
                 num_kv_heads: int, head_dim: int):
        super().__init__()
        self.wq = init.dense((d_model, num_heads * head_dim))
        self.wk = init.dense((d_model, num_kv_heads * head_dim))
        self.wv = init.dense((d_model, num_kv_heads * head_dim))
        self.wo = init.dense((num_heads * head_dim, d_model),
                             scale=(num_heads * head_dim) ** -0.5)


def _bias(ok: torch.Tensor) -> torch.Tensor:
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill_(~ok, NEG)


def _mask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Sk) additive mask bias from position vectors; window <= 0
    means full attention."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    return _bias(ok)


def _sdpa_dense(q, k, v, bias):
    """q (B,Sq,H,hd), k/v (B,Sk,K,hd) with H = K*G; bias (Sq,Sk) or
    (B,Sq,Sk) (per-row masks for continuous batching). Scores are rounded
    to the compute dtype before the float32 softmax, and the weights cast
    back to ``v``'s dtype, as the JAX package does."""
    b, sq, h, hd = q.shape
    kheads = k.shape[2]
    g = h // kheads
    q = q.reshape(b, sq, kheads, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    bias = bias[:, None, None] if bias.dim() == 3 else bias[None, None, None]
    scores = scores * (hd ** -0.5) + bias
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(b, sq, h, hd)


def _pad_seq(x, n: int, value=0):
    """Pad axis 1 of ``x`` by ``n`` entries of ``value``."""
    if n == 0:
        return x
    shape = (x.shape[0], n) + tuple(x.shape[2:])
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=1)


def _sdpa_flash(q, k, v, q_pos, k_pos, causal, window, q_block, k_block,
                skip_masked: bool = True):
    """Online-softmax chunked attention: memory O(q_block * k_block).

    The running max starts at 0, not -inf: a fully masked kv block then
    contributes exp(-1e30) = 0 instead of exp(0) = 1, and the online
    softmax is exact for any monotone baseline m >= 0. Rows past ``sq`` /
    ``sk`` are padded with positions -10**9 and 2**30.

    A kv block that every query of the block masks leaves m, lsum and acc
    exactly as they were (p = 0, corr = exp(0) = 1), so it is skipped: the
    causal blocks above the diagonal and, for a local window, the blocks
    wholly out of reach. The output is the same, bit for bit (held by
    ``skip_masked=False``, which visits every block).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    kheads = k.shape[2]
    g = h // kheads
    nq = -(-sq // q_block)
    nk = -(-sk // k_block)
    qp = _pad_seq(q, nq * q_block - sq).reshape(b, nq, q_block, kheads, g,
                                                 hd)
    kp = _pad_seq(k, nk * k_block - sk).reshape(b, nk, k_block, kheads, hd)
    vp = _pad_seq(v, nk * k_block - sk).reshape(b, nk, k_block, kheads, hd)
    qpos = _pad_seq(q_pos[None], nq * q_block - sq, -(10 ** 9))[0]
    kpos = _pad_seq(k_pos[None], nk * k_block - sk, 2 ** 30)[0]
    scale = hd ** -0.5
    # Block position ranges on the host (one copy a call) for the skip test.
    q_rng = qpos.reshape(nq, q_block)
    k_rng = kpos.reshape(nk, k_block)
    q_rng = torch.stack([q_rng.amin(1), q_rng.amax(1)], 1).tolist()
    k_rng = torch.stack([k_rng.amin(1), k_rng.amax(1)], 1).tolist()
    outs = []
    for i in range(nq):
        qb = qp[:, i]  # (B, q_block, K, G, hd)
        qpb = qpos[i * q_block:(i + 1) * q_block]
        m = torch.zeros((b, kheads, g, q_block), dtype=torch.float32,
                        device=q.device)
        lsum = torch.zeros_like(m)
        acc = torch.zeros((b, kheads, g, q_block, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            if skip_masked and (
                    (causal and q_rng[i][1] < k_rng[j][0]) or
                    (window > 0 and q_rng[i][0] - k_rng[j][1] >= window)):
                continue  # every (query, key) pair of the block is masked
            kb, vb = kp[:, j], vp[:, j]
            kpb = kpos[j * k_block:(j + 1) * k_block]
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb).float()
            s.mul_(scale).add_(_mask_bias(qpb, kpb, causal, window))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # Out of place: ``amax`` keeps ``s`` for its gradient.
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(vb.dtype), vb).float()
            m = m_new
        out = acc / torch.clamp(lsum[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, q_block, K, G, hd)
    out = torch.stack(outs, dim=1).reshape(b, nq * q_block, h, hd)
    return out[:, :sq].to(q.dtype)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a local step's
    einsum gradients are strided, and DTensor's views of them (the head
    split of a projection) need them dense."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, with a contiguous gradient in the backward pass."""
    return _ContiguousGrad.apply(x)


def _heads_local(fn, q, k, v, *args):
    """``fn(q, k, v, *args)`` (an attention core over (B, S, heads, hd)
    tensors); under a mesh, as an explicit step on each rank's heads.

    Heads are independent, so each rank runs ``fn`` on its local rows and
    heads, and DTensor never meets the cores' einsums (the card's torch
    2.11 cannot place their flattening views). k and v take q's head
    sharding when their head count allows it (then a rank's query heads
    are the groups of its kv heads); with one kv head (MQA) they stay
    whole and their local gradient is a partial sum over the head-sharded
    dims; otherwise the query heads are gathered too."""
    if not is_dtensor(q):
        return fn(q, k, v, *args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in q.placements]
    heads = [i for i, pl in enumerate(q.placements)
             if isinstance(pl, Shard) and pl.dim == 2]
    split = math.prod(mesh.size(i) for i in heads)
    kheads = k.shape[2]
    if kheads % split == 0:
        qp = kp = [Shard(2) if i in heads else pl
                   for i, pl in enumerate(rows)]
        kgrad = kp
    elif kheads == 1:
        qp = [Shard(2) if i in heads else pl for i, pl in enumerate(rows)]
        kp, kgrad = rows, [Partial() if i in heads else pl
                           for i, pl in enumerate(rows)]
    else:
        qp = kp = kgrad = rows
    ql = contiguous_grad(q.redistribute(mesh, qp).to_local())
    kl = contiguous_grad(k.redistribute(mesh, kp).to_local(
        grad_placements=kgrad))
    vl = contiguous_grad(v.redistribute(mesh, kp).to_local(
        grad_placements=kgrad))
    return DTensor.from_local(fn(ql, kl, vl, *args).contiguous(), mesh, qp)


def _write_cache(cache, new, start):
    """``dynamic_update_slice`` of ``new`` (B, Sq, ...) into ``cache``
    (B, S, ...) at per-row ``start`` (B,), each start clamped so that the
    update fits, as XLA clamps. Returns a new tensor."""
    b, sq = new.shape[:2]
    start = torch.clamp(start, 0, cache.shape[1] - sq)
    idx = start[:, None] + torch.arange(sq, device=cache.device)
    out = cache.clone()
    out[torch.arange(b, device=cache.device)[:, None], idx] = new.to(
        cache.dtype)
    return out


def _cached_core(q, k, v, kc, vc, cache_position, pos2d, causal, window):
    """Attention of (B, Sq) queries against a cache after writing k and v
    into it at ``cache_position``: (out, new k cache, new v cache)."""
    b, sq = q.shape[:2]
    cp = torch.as_tensor(cache_position, device=q.device)
    starts = cp.expand(b) if cp.dim() == 0 else cp
    ck = _write_cache(kc, k, starts)
    cv = _write_cache(vc, v, starts)
    sk = ck.shape[1]
    k_pos = torch.arange(sk, device=q.device)
    if cp.dim() == 0:
        bias = _mask_bias(pos2d[0], k_pos, causal, window)  # (Sq, Sk)
        written = k_pos[None, :] <= cp + sq - 1
        bias = bias + _bias(written)
    else:  # per-row positions -> (B, Sq, Sk) bias
        diff = pos2d[:, :, None] - k_pos[None, None, :]
        ok = torch.ones(diff.shape, dtype=torch.bool, device=q.device)
        if causal:
            ok &= diff >= 0
        if window > 0:
            ok &= diff < window
        ok &= k_pos[None, None, :] <= (cp[:, None, None] + sq - 1)
        bias = _bias(ok)
    return _sdpa_dense(q, ck.to(q.dtype), cv.to(q.dtype), bias), ck, cv


def _cached_local(q, k, v, kv_cache, cache_position, pos2d, causal, window):
    """:func:`_cached_core` under a mesh, as an explicit step on each
    rank's batch rows: DTensor has no placement for the cache write's
    ``index_put_`` on a sharded cache. Every other dim (heads, and the
    cache's sequence when it is sharded) is gathered for the step, and the
    new caches are placed back as the old ones were (a local slice). A
    scalar ``cache_position`` only (the decode step's)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if torch.as_tensor(cache_position).dim():
        raise NotImplementedError("per-row cache positions under a mesh")
    mesh = q.device_mesh
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in q.placements]

    def loc(t):
        if not is_dtensor(t):  # a plain (replicated) cache: its rows
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
        return t.redistribute(mesh, rows).to_local()

    out, ck, cv = _cached_core(loc(q), loc(k), loc(v), loc(kv_cache[0]),
                               loc(kv_cache[1]), cache_position, pos2d,
                               causal, window)

    def back(t, like):
        t = DTensor.from_local(t, mesh, rows)
        return t.redistribute(mesh, like.placements) if is_dtensor(
            like) else t

    return (DTensor.from_local(out, mesh, rows), back(ck, kv_cache[0]),
            back(cv, kv_cache[1]))


def attention(
    p,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    causal: bool = True,
    window: int = 0,
    rope_theta: float = 1e4,
    mrope_sections: Optional[tuple] = None,
    kv_cache: Optional[tuple] = None,
    cache_position=None,
    flash_q_block: int = 512,
    flash_kv_block: int = 512,
    dense_threshold: int = 2048,
):
    """Full attention layer. Returns (out, new_kv) where new_kv is the
    (k, v) pair — the full sequence for prefill, or the updated cache for
    decode (``kv_cache`` + ``cache_position`` given).

    ``cache_position`` is a scalar write index (an int, or a 0-d tensor),
    or a (B,) tensor of per-row indices (the continuous-batching path:
    each slot decodes at its own offset). The scalar path masks with row
    0's positions for every row, as the JAX package does.
    """
    b, sq, _ = x.shape
    q = (x @ p.wq).reshape(b, sq, num_heads, head_dim)
    k = (x @ p.wk).reshape(b, sq, num_kv_heads, head_dim)
    v = (x @ p.wv).reshape(b, sq, num_kv_heads, head_dim)
    q = logical(q, "batch", "attn_seq", "heads", None)
    k = logical(k, "batch", "attn_seq", "kv_heads", None)
    pos2d = positions if positions.dim() == 2 else positions[..., 0]
    if is_dtensor(pos2d):  # placed positions (M-RoPE's batch input)
        pos2d = pos2d.full_tensor()  # the masks read row 0's, whole
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta, mrope_sections)
        k = apply_rope(k, positions, rope_theta, mrope_sections)

    if kv_cache is not None:
        if is_dtensor(q):
            out, ck, cv = _cached_local(q, k, v, kv_cache, cache_position,
                                        pos2d, causal, window)
        else:
            out, ck, cv = _cached_core(q, k, v, kv_cache[0], kv_cache[1],
                                       cache_position, pos2d, causal, window)
        new_kv = (ck, cv)
    else:
        if sq <= dense_threshold:
            bias = _mask_bias(pos2d[0], pos2d[0], causal, window)
            out = _heads_local(_sdpa_dense, q, k, v, bias)
        else:
            out = _heads_local(_sdpa_flash, q, k, v, pos2d[0], pos2d[0],
                               causal, window,
                              flash_q_block, flash_kv_block)
        new_kv = (k, v)
    out = logical(out, "batch", "attn_seq", "heads", None)
    out = out.reshape(b, sq, num_heads * head_dim)
    return out @ p.wo, new_kv


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """The token table (vocab, d_model)."""

    def __init__(self, init: Init, vocab: int, d_model: int):
        super().__init__()
        self.table = init.normal((vocab, d_model), 1.0)


class Head(nn.Module):
    """An untied output projection (d_model, vocab)."""

    def __init__(self, init: Init, d_model: int, vocab: int):
        super().__init__()
        self.w = init.dense((d_model, vocab))


def embed(p, tokens):
    """Token ids -> rows of the table."""
    if is_dtensor(p.table):
        return logical(_embed_local(p.table, tokens), "batch", "seq", "embed")
    return logical(p.table[tokens], "batch", "seq", "embed")


def _embed_local(table, tokens):
    """The lookup under a mesh, as an explicit step on local tensors.
    DTensor has no lookup for a table sharded on both dims (the
    ``("tp", "fsdp")`` rule), and the card's torch 2.11 fails to place the
    ``index_put`` of the lookup's backward. So the table is gathered whole
    on every rank, each rank looks up its own rows of tokens, and the
    table's local gradient is declared a partial sum over the dims the
    tokens are sharded on (each rank saw only its rows)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    placed = (list(tokens.placements) if is_dtensor(tokens)
              else [Replicate()] * mesh.ndim)
    grads = [Partial() if isinstance(pl, Shard) else Replicate()
             for pl in placed]
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grads)
    ids = tokens.to_local() if is_dtensor(tokens) else tokens
    return DTensor.from_local(whole[ids], mesh, placed)


def unembed(p_embed, tokens_hidden, head=None):
    """Hidden states -> logits, through ``head`` or the tied table."""
    if head is not None:
        return tokens_hidden @ head.w
    return tokens_hidden @ p_embed.table.T.to(tokens_hidden.dtype)

"""RWKV-6 "Finch" block: data-dependent-decay linear attention (TimeMix) +
squared-ReLU ChannelMix, both with token-shift.

The port of ``repro/models/rwkv.py``. TimeMix keeps a per-head matrix
state S in R^{hd x hd}:

    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t
    o_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)

with w_t in (0,1) data-dependent via a low-rank MLP, and u the "bonus" for
the current token. Prefill uses the chunked formulation (decays in log
space, intra-chunk interactions as (chunk x chunk) masked matmuls, the
state chained between chunks); decode carries (last_x_tm, last_x_cm, S)
per layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.layers import Init, _mm


class TimeMix(nn.Module):
    """RWKV-6 time mixing's parameters: token-shift mixes, the r/k/v/g/o
    projections, the data-dependent decay (``w0``, LoRA ``w1``/``w2``),
    the bonus ``u`` and the output norm."""

    def __init__(self, init: Init, d_model: int, head_dim: int = 64,
                 lora_r: int = 32):
        super().__init__()
        h = d_model // head_dim
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, init.full((d_model,), 0.5))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, init.dense((d_model, d_model)))
        # data-dependent decay: w = exp(-exp(w0 + tanh(x W1) W2))
        self.w0 = init.full((d_model,), -6.0)
        self.w1 = init.dense((d_model, lora_r))
        self.w2 = init.dense((lora_r, d_model))
        self.u = init.normal((h, head_dim), 0.1)
        self.ln_out = init.full((d_model,), 1.0)


class ChannelMix(nn.Module):
    """RWKV channel mixing's parameters: ``mu_k``, ``wk``, ``wv``."""

    def __init__(self, init: Init, d_model: int, d_ff: int):
        super().__init__()
        self.mu_k = init.full((d_model,), 0.5)
        self.wk = init.dense((d_model, d_ff))
        self.wv = init.dense((d_ff, d_model))


def _token_shift(x, last):
    """shifted[t] = x[t-1]; position -1 comes from the carried state."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, logw, u, s0, chunk):
    """Chunked WKV. r,k,v (B,S,H,hd); logw (B,S,H,hd) (<=0); u (H,hd);
    s0 (B,H,hd,hd). Returns (o (B,S,H,hd), s_final)."""
    s = r.shape[1]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    s_prev = s0
    outs = []
    for c0 in range(0, s, chunk):
        rc, kc, vc, lwc = (t[:, c0:c0 + chunk] for t in (r, k, v, logw))
        cum = torch.cumsum(lwc, dim=1)  # inclusive cumsum of log decay
        total = cum[:, -1]  # (B, H, hd)
        # Inter-chunk: the state entering position t has been decayed by
        # w_1..w_t (inclusive).
        r_dec = rc * torch.exp(cum)
        o_inter = torch.einsum("bthd,bhde->bthe", r_dec, s_prev)
        # Intra-chunk: k_j v_j reaches o_t (j < t) decayed by
        # w_{j+1}..w_t = exp(cum_t - cum_j).
        k_sc = kc * torch.exp(-cum)
        att = torch.einsum("bthd,bjhd->bhtj", r_dec, k_sc)
        att = torch.where(tri[None, None], att, 0.0)
        # current-token bonus: r_t . (u * k_t)
        diag = torch.einsum("bthd,bthd->bth", rc, kc * u[None, None])
        o_intra = torch.einsum("bhtj,bjhe->bthe", att, vc) + \
            diag[..., None] * vc
        # S_new = diag(exp(total)) S_prev + sum_j (k_j decayed to the end) v_j^T
        k_end = kc * torch.exp(total[:, None] - cum)
        s_prev = s_prev * torch.exp(total)[..., None] + torch.einsum(
            "bjhd,bjhe->bhde", k_end, vc)
        outs.append(o_inter + o_intra)
    return torch.cat(outs, dim=1), s_prev


def rwkv_timemix(p, x, *, head_dim=64, chunk=64, state=None):
    """x (B,S,D) -> (y, (last_x, S_state))."""
    b, s, d = x.shape
    h = d // head_dim
    last = state[0] if state is not None else torch.zeros(
        (b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, last)

    def mix(mu):
        return x + (xs - x) * mu.to(x.dtype)

    r = (mix(p.mu_r) @ p.wr).reshape(b, s, h, head_dim)
    k = (mix(p.mu_k) @ p.wk).reshape(b, s, h, head_dim)
    v = (mix(p.mu_v) @ p.wv).reshape(b, s, h, head_dim)
    g = layers.silu(mix(p.mu_g) @ p.wg)
    # Finch: data-dependent decay (low-rank), w in (0,1), logw <= 0.
    wx = mix(p.mu_w)
    logw = -torch.exp(p.w0 + _mm(torch.tanh(_mm(wx.float(), p.w1)), p.w2))
    # Stability clamp: the chunked factorization materializes exp(-cumsum);
    # bounding the per-step log-decay at -2 keeps that factor < e^64 for
    # chunk=32 (f32-safe).
    logw = torch.clamp(logw, min=-2.0)
    logw = logw.reshape(b, s, h, head_dim)

    s0 = (state[1] if state is not None else
          torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32,
                      device=x.device))
    rf, kf, vf = (t.float() for t in (r, k, v))
    if s == 1:  # decode fast path
        w1 = torch.exp(logw[:, 0])  # (B,H,hd)
        o = torch.einsum("bhd,bhde->bhe", rf[:, 0] * w1, s0) + \
            torch.einsum("bhd,bhd,bhe->bhe", rf[:, 0], kf[:, 0] * p.u,
                         vf[:, 0])
        s_f = s0 * w1[..., None] + torch.einsum(
            "bhd,bhe->bhde", kf[:, 0], vf[:, 0])
        o = o[:, None]
    else:
        pad = (-s) % chunk
        if pad:
            rf, kf, vf, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                                for t in (rf, kf, vf, logw))
        o, s_f = _wkv_chunked(rf, kf, vf, logw, p.u, s0, chunk)
        o = o[:, :s]
    o = o.reshape(b, s, h, head_dim)
    # per-head group norm
    mu = o.mean(dim=-1, keepdim=True)
    var = ((o - mu) ** 2).mean(dim=-1, keepdim=True)
    o = (o - mu) * torch.rsqrt(var + 1e-5)
    o = o.reshape(b, s, d) * p.ln_out
    y = (o.to(x.dtype) * g) @ p.wo
    return y, (x[:, -1], s_f)


def rwkv_channelmix(p, x, state=None):
    """Squared-ReLU FFN over the token-shifted input; returns (y, the last
    position's x for the next call)."""
    b, s, d = x.shape
    last = state if state is not None else torch.zeros(
        (b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, last)
    xk = x + (xs - x) * p.mu_k.to(x.dtype)
    h = torch.square(F.relu(xk @ p.wk))
    h = layers.logical(h, "batch", "mlp_seq", "mlp")
    return h @ p.wv, x[:, -1]

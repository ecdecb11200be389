"""Mamba-1 selective SSM block (Jamba's sequence mixer).

The port of ``repro/models/mamba.py``. Diagonal selective state space: per
channel c and state dim n,

    h_t = exp(dt_t * A)[c,n] * h_{t-1} + dt_t * B_t[n] * x_t[c]
    y_t = sum_n C_t[n] * h_t[c,n] + D[c] * x_t[c]

Prefill runs the recurrence chunk by chunk: within a chunk the input term
``u`` is scanned step by step and the chunk's starting state enters as
``h0 * exp(cumsum(log decay))``, the JAX package's chunk formula. JAX scans
``u`` with ``lax.associative_scan``, whose sum order differs, so the two
agree within a tolerance, not bit for bit. Decode carries (conv_state,
ssm_state) and costs O(1) per token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.layers import Init


class Mamba(nn.Module):
    """A Mamba block's parameters: input projection, causal conv, the
    selective-scan projections, ``A_log``/``D`` and the output projection."""

    def __init__(self, init: Init, d_model: int, d_state: int = 16,
                 d_conv: int = 4, expand: int = 2, dt_rank=None):
        super().__init__()
        d_inner = expand * d_model
        dt_rank = dt_rank or max(d_model // 16, 1)
        self.in_proj = init.dense((d_model, 2 * d_inner))
        self.conv_w = init.normal((d_conv, d_inner), d_conv ** -0.5)
        self.conv_b = init.full((d_inner,), 0.0)
        self.x_to_bc = init.dense((d_inner, 2 * d_state))
        self.x_to_dt = init.dense((d_inner, dt_rank))
        self.dt_proj = init.dense((dt_rank, d_inner), scale=dt_rank ** -0.5)
        # dt_bias = log(expm1(0.01)); A_log = log(1..N) (S4D-real), in f32.
        self.dt_bias = init.full((d_inner,), 0.0)
        self.A_log = init.full((d_inner, d_state), 0.0)
        self.D = init.full((d_inner,), 1.0)
        self.out_proj = init.dense((d_inner, d_model))
        with torch.no_grad():
            self.dt_bias.copy_(torch.log(torch.expm1(torch.full(
                (d_inner,), 1e-2, dtype=torch.float32, device=init.device))))
            self.A_log.copy_(torch.log(torch.arange(
                1, d_state + 1, dtype=torch.float32,
                device=init.device))[None, :].expand(d_inner, d_state))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv over S. x (B,S,C), w (K,C). Returns (y, tail)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)  # (B, K-1, C) trailing inputs
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1]] * w[i][None, None].to(x.dtype)
            for i in range(k))
    return y + b.to(x.dtype), xp[:, -(k - 1):]


def _ssm_chunked(x, dt, b_t, c_t, a, h0, chunk):
    """Chunked diagonal selective scan.

    x, dt: (B, S, C); b_t, c_t: (B, S, N); a: (C, N); h0: (B, C, N).
    Returns (y (B,S,C), h_final). S % chunk == 0 (caller pads).
    """
    bsz, s, c = x.shape
    h = h0
    ys = []
    for c0 in range(0, s, chunk):
        xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        bc, cc = b_t[:, c0:c0 + chunk], c_t[:, c0:c0 + chunk]
        # log decay per step: (B, chunk, C, N)
        la = dtc[..., None] * (-a)[None, None]  # positive a -> -a*dt
        bx = (dtc * xc)[..., None] * bc[:, :, None, :]  # (B,chunk,C,N)
        la_c = torch.cumsum(la, dim=1)
        u = [bx[:, 0]]
        for t in range(1, la.shape[1]):
            u.append(u[-1] * torch.exp(la[:, t]) + bx[:, t])
        h_t = torch.stack(u, dim=1) + h[:, None] * torch.exp(la_c)
        ys.append(torch.einsum("bscn,bsn->bsc", h_t, cc))
        h = h_t[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_block(p, x, *, d_state=16, chunk=64, state=None):
    """x (B, S, d_model) -> (y, new_state). state = (conv_tail, h)."""
    bsz, s, _ = x.shape
    d_inner = p.A_log.shape[0]
    xz = x @ p.in_proj
    xin, z = torch.chunk(xz, 2, dim=-1)
    conv_state = state[0] if state is not None else None
    xc, conv_tail = _causal_conv(xin, p.conv_w, p.conv_b, conv_state)
    xc = layers.silu(xc)
    bc = xc @ p.x_to_bc
    b_t, c_t = torch.chunk(bc, 2, dim=-1)  # (B,S,N) each
    dt = layers.softplus(
        (xc @ p.x_to_dt) @ p.dt_proj + p.dt_bias)  # (B,S,C)
    a = torch.exp(p.A_log)  # (C, N), positive; decay = exp(-dt*a)
    h0 = (state[1] if state is not None else
          torch.zeros((bsz, d_inner, d_state), dtype=torch.float32,
                      device=x.device))

    if s == 1:  # decode fast path
        la = (dt[:, 0, :, None] * (-a)[None]).float()
        h = h0 * torch.exp(la) + ((dt[:, 0] * xc[:, 0])[..., None] *
                                  b_t[:, 0, None, :]).float()
        y = torch.einsum("bcn,bn->bc", h, c_t[:, 0].float())[:, None]
        y = y.to(x.dtype)
        h_f = h
    else:
        pad = (-s) % chunk

        def padded(t):
            return F.pad(t, (0, 0, 0, pad)).float()

        y, h_f = _ssm_chunked(padded(xc), padded(dt), padded(b_t),
                              padded(c_t), a, h0, chunk)
        y = y[:, :s].to(x.dtype)
    y = y + xc * p.D.to(xc.dtype)
    y = y * layers.silu(z)
    return y @ p.out_proj, (conv_tail, h_f)


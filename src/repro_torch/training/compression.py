"""Gradient compression: quantize a gradient and back (bf16 or int8).

The port of ``repro/training/compression.py``. In the JAX package it
stands in for a compressed cross-pod all-reduce: the gradient values pass
through the compressed form, so the information lost is that of the wire
format. On one card it is the same arithmetic on the same values; the
error-feedback variant carries each step's quantization residual into the
next (Seide et al.). Equal to the JAX package bit for bit on the CPU:
``torch.round`` and ``jnp.round`` both round half to even.

Each function takes one leaf of the JAX package's tree. The int8 scale is
the leaf's largest magnitude, so a stacked leaf (``blocks``, ``periods``)
shares one scale: ``train_step`` takes it over the whole group (and over
every rank's blocks under a mesh) and passes it in.
"""

from __future__ import annotations

from typing import Optional

import torch


def int8_scale(g: torch.Tensor) -> torch.Tensor:
    """The int8 step of a leaf: its largest magnitude over 127."""
    return torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0


def compress_decompress(g: torch.Tensor, method: str = "bf16", *,
                        scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round-trip a gradient leaf through the compressed representation.
    ``scale`` is the int8 step when ``g`` is a block of its leaf (default:
    :func:`int8_scale` of ``g``)."""
    if method == "none" or g.dim() == 0:
        return g
    if method == "bf16":
        return g.to(torch.bfloat16).to(torch.float32)
    if method == "int8":
        if scale is None:
            scale = int8_scale(g)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q.to(torch.float32) * scale
    raise ValueError(f"unknown compression {method!r}")


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor,
                           method: str = "int8"):
    """Error-feedback compression: returns (decompressed, new_residual)."""
    if method == "none" or g.dim() == 0:
        return g, residual
    corrected = g + residual
    out = compress_decompress(corrected, method)
    return out, corrected - out


def tree_compress_with_feedback(grads, residuals, method: str = "int8"):
    """:func:`compress_with_feedback` over matching dicts or sequences of
    leaves; returns (decompressed, new residuals) in the same structure."""
    if isinstance(grads, dict):
        outs = {k: compress_with_feedback(grads[k], residuals[k], method)
                for k in grads}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    outs = [compress_with_feedback(g, r, method)
            for g, r in zip(grads, residuals)]
    return [o[0] for o in outs], [o[1] for o in outs]

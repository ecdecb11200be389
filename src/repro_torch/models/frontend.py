"""Modality frontend stubs (the port of ``repro/models/frontend.py``): the
transformer backbone is the deliverable, and the inputs are precomputed
frame or patch embeddings.

audio  (hubert-xlarge): inputs are (B, S, frontend_dim) precomputed frame
       features; a linear projection maps them to d_model.
vision (qwen2-vl): inputs are tokens plus (B, vision_tokens, frontend_dim)
       precomputed patch embeddings; they are projected and overwrite the
       first ``vision_tokens`` positions.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.layers import Init


class Frontend(nn.Module):
    """The audio or vision stub's projection (frontend_dim, d_model)."""

    def __init__(self, init: Init, frontend_dim: int, d_model: int):
        super().__init__()
        self.proj = init.dense((frontend_dim, d_model))


def audio_embed(p, frames):
    """(B, S, frontend_dim) precomputed frames -> (B, S, d_model)."""
    return layers.logical(frames @ p.proj, "batch", "seq", "embed")


def vision_merge(p, token_embeds, patch_embeds):
    """Overwrite the first Tv positions of the token embedding with the
    projected patch embeddings (static prefix layout)."""
    tv = patch_embeds.shape[1]
    vis = patch_embeds @ p.proj.to(patch_embeds.dtype)
    return torch.cat([vis.to(token_embeds.dtype), token_embeds[:, tv:]],
                     dim=1)

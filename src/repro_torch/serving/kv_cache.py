"""KV-cache utilities: layout and padding.

The port of ``repro/serving/kv_cache.py``. Cache trees (see
``Model.init_cache``) are nested dicts with these leaf kinds, matched by
key, in the JAX package's layouts:

  k / v            (L, B, S, K, hd)        attention cache, stacked layers
  attn_k / attn_v  (P, n, B, S, K, hd)     jamba period-stacked attention
  wkv              (L, B, H, hd, hd)       rwkv matrix state
  tm_x / cm_x      (L, B, D)               rwkv token-shift state
  mamba_conv       (P, n, B, K-1, C)       mamba conv tail
  mamba_ssm        (P, n, B, C, N)         mamba ssm state

The JAX package's mesh-sharding policy (``cache_pspec_tree``,
``cache_sharding_tree``, ``shard_cache``) has no counterpart on one card.
"""

from __future__ import annotations

import torch.nn.functional as F

ATTENTION_LEAVES = ("k", "v", "attn_k", "attn_v")


def pad_cache_to(cache: dict, max_len: int) -> dict:
    """Grow attention cache leaves (.., S, K, hd) to S = max_len after a
    prefill, making room for decode. Recurrent leaves pass through."""
    out = {}
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            out[name] = pad_cache_to(leaf, max_len)
        elif name in ATTENTION_LEAVES and leaf.shape[-3] < max_len:
            out[name] = F.pad(leaf, (0, 0, 0, 0, 0, max_len - leaf.shape[-3]))
        else:
            out[name] = leaf
    return out

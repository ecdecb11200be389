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

Sharding policy over a ``DeviceMesh`` (the JAX package's ``:50-113``):
batch over the data axes everywhere. Attention caches take the model axis
on kv-heads when divisible, else on the sequence axis (the flash-decode
layout for MQA like granite's kv=1). Recurrent states take the model axis
on their channel/head dimension. A spec is a tuple of mesh-axis names per
dimension, as ``training/sharding.py`` writes one; ``shard_cache`` places
each leaf as a DTensor.
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

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


def cache_pspec_tree(cache_tree, cfg: ModelConfig, batch_axes=("data",),
                     model_axis: str = "model", model_size: int = 1,
                     seq_axes: tuple = ()):
    """Spec tree for a cache (tensors, or anything with a ``shape``).

    ``seq_axes``: shard the attention-cache sequence dim over these axes
    instead of batch-sharding: the long-context/small-batch layout (e.g.
    long_500k at batch 1: batch can't shard, the 500k cache must).
    """
    kv_on_model = model_size > 1 and cfg.num_kv_heads and \
        cfg.num_kv_heads % model_size == 0
    batch_axes = tuple(batch_axes) if batch_axes else None

    def spec(name, leaf):
        ndim = len(leaf.shape)
        if name in ATTENTION_LEAVES:
            lead = (None,) * (ndim - 4)
            if seq_axes:
                kv_ax = model_axis if kv_on_model else None
                return (*lead, None, tuple(seq_axes), kv_ax, None)
            if kv_on_model:
                return (*lead, batch_axes, None, model_axis, None)
            return (*lead, batch_axes, model_axis, None, None)
        if name == "wkv":  # (L, B, H, hd, hd)
            heads = leaf.shape[2]
            ax = model_axis if (model_size > 1 and heads % model_size == 0) \
                else None
            return (None, batch_axes, ax, None, None)
        if name in ("tm_x", "cm_x"):  # (L, B, D)
            dim = leaf.shape[-1]
            ax = model_axis if (model_size > 1 and dim % model_size == 0) \
                else None
            return (None, batch_axes, ax)
        if name == "mamba_conv":  # (..., B, K-1, C)
            lead = (None,) * (ndim - 3)
            ax = model_axis if (model_size > 1 and
                                leaf.shape[-1] % model_size == 0) else None
            return (*lead, batch_axes, None, ax)
        if name == "mamba_ssm":  # (..., B, C, N)
            lead = (None,) * (ndim - 3)
            ax = model_axis if (model_size > 1 and
                                leaf.shape[-2] % model_size == 0) else None
            return (*lead, batch_axes, ax, None)
        return ()

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else spec(k, v)
                for k, v in tree.items()}

    return walk(cache_tree)


def cache_sharding_tree(cache_tree, mesh, cfg: ModelConfig,
                        batch_axes=("data",), model_axis: str = "model",
                        seq_axes: tuple = ()):
    """``NamedSharding`` tree matching a cache tree."""
    from repro_torch.training.sharding import NamedSharding, axis_sizes

    model_size = axis_sizes(mesh).get(model_axis, 1)
    specs = cache_pspec_tree(cache_tree, cfg, batch_axes, model_axis,
                             model_size, seq_axes)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else NamedSharding(mesh, v)
                for k, v in tree.items()}

    return walk(specs)


def shard_cache(cache, mesh, cfg: ModelConfig, batch_axes=("data",),
                model_axis: str = "model"):
    """Place a cache tree (every rank holding it in full) under
    :func:`cache_sharding_tree`'s layout: a tree of DTensors."""
    shardings = cache_sharding_tree(cache, mesh, cfg, batch_axes, model_axis)

    def walk(tree, sh):
        return {k: walk(v, sh[k]) if isinstance(v, dict) else sh[k].place(v)
                for k, v in tree.items()}

    return walk(cache, shardings)

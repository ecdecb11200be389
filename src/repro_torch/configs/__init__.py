"""Workload configurations of the port: the ParIS+ index (``paris``) and
the LM architecture zoo, copies of the JAX package's ``configs``.

``--arch <id>`` resolves through :func:`get_config` (the published shape)
and :func:`get_smoke_config` (a reduced same-family config for the CPU).
"""

import importlib

from repro_torch.configs.base import (
    ModelConfig,
    SHAPES,
    ShapeConfig,
    shape_applicable,
)

# arch id -> module name
_ARCH_MODULES = {
    "granite-34b": "granite_34b",
    "gemma3-27b": "gemma3_27b",
    "internlm2-20b": "internlm2_20b",
    "starcoder2-15b": "starcoder2_15b",
    "hubert-xlarge": "hubert_xlarge",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "paris": "paris",
}

ARCH_IDS = [a for a in _ARCH_MODULES if a != "paris"]
ALL_IDS = list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str):
    """The published configuration of ``arch``."""
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    """The reduced same-family configuration of ``arch``."""
    return _module(arch).smoke_config()


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
    "ARCH_IDS", "ALL_IDS", "get_config", "get_smoke_config",
]

"""Config schema: model architectures and input-shape workloads.

The port's copy of ``repro/configs/base.py`` (pure dataclasses, field for
field). Every architecture has one ``src/repro_torch/configs/<id>.py``
exporting ``CONFIG`` (the exact published shape) and ``smoke_config()`` (a
reduced same-family config for CPU smoke tests). The registry in
``__init__.py`` resolves ``--arch <id>``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One model architecture: widths, depth, attention, MoE, recurrent and
    frontend knobs, and the compute dtype."""

    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int  # 0 for attention-free archs
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    causal: bool = True
    sliding_window: int = 0  # >0: local-attention window size
    global_every: int = 0  # gemma3: every k-th layer is global, rest local
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    mlp_type: str = "swiglu"  # swiglu | gelu | relu2
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1  # MoE on layers where (idx % moe_every == moe_offset)
    moe_offset: int = 0
    first_k_dense: int = 0  # deepseek: first k layers use a dense FFN
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # hybrid (jamba): repeating layer-kind pattern; () = homogeneous
    block_pattern: Tuple[str, ...] = ()  # e.g. ("mamba",)*3+("attn",)+...
    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 64
    # rwkv
    rwkv: bool = False
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32
    # frontend stub (audio/vlm): provides precomputed embeddings
    frontend: str = "none"  # none | audio | vision
    frontend_dim: int = 0
    vision_tokens: int = 0  # vlm: #patch embeddings prepended
    # attention evaluation strategy (roofline levers; see §Perf)
    attn_dense_threshold: int = 2048  # <= this seq: dense scores, else flash
    attn_flash_q_block: int = 512
    attn_flash_kv_block: int = 512
    # moe dispatch scope: "global" (pjit-propagated) or "local"
    # (shard_map-manual over the batch axes; EP stays on the model axis)
    moe_dispatch: str = "global"
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def attention_free(self) -> bool:
        """True for RWKV: no layer attends, so there is no KV cache."""
        return self.rwkv

    @property
    def is_encoder(self) -> bool:
        """True for a bidirectional encoder (no causal mask, no decode)."""
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with a 500k context? (SSM/hybrid/local-attn)"""
        if self.rwkv or self.block_pattern:
            return True
        return self.sliding_window > 0  # local:global mixes qualify

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        kinds = self._layer_kinds()
        total = v * d + d  # embed + final norm
        if not self.tie_embeddings:
            total += d * v
        if self.frontend != "none":
            total += self.frontend_dim * d
        for i, kind in enumerate(kinds):
            if kind == "attn" or kind == "attn+ffn":
                hq = self.num_heads * self.head_dim
                hk = self.num_kv_heads * self.head_dim
                total += d * (hq + 2 * hk) + hq * d + d  # qkv + o + ln
            if kind == "mamba":
                di = self.mamba_expand * d
                dtr = max(d // 16, 1)
                total += (d * 2 * di + self.mamba_d_conv * di + di
                          + di * 2 * self.mamba_d_state + di * dtr
                          + dtr * di + di + di * self.mamba_d_state
                          + di + di * d + d)
            if kind == "rwkv":
                total += 5 * d * d + d * 32 + 32 * d + 8 * d  # timemix approx
                total += d * f + f * d + 3 * d  # channelmix
                continue
            # FFN part for attn/mamba layers
            if self._is_moe_layer(i):
                e = self.num_experts
                fe = self.d_ff_expert
                total += d * e + e * 3 * d * fe + d
                if self.num_shared_experts:
                    total += 3 * d * (fe * self.num_shared_experts)
            else:
                ff = f
                mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                total += mult * d * ff + d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-to experts)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        d, fe, e = self.d_model, self.d_ff_expert, self.num_experts
        n_moe = sum(self._is_moe_layer(i) for i in
                    range(len(self._layer_kinds())))
        unused = n_moe * 3 * d * fe * (e - self.num_experts_per_tok)
        return full - unused

    def _layer_kinds(self):
        if self.block_pattern:
            pat = list(self.block_pattern)
            reps = -(-self.num_layers // len(pat))
            return (pat * reps)[: self.num_layers]
        if self.rwkv:
            return ["rwkv"] * self.num_layers
        return ["attn"] * self.num_layers

    def _is_moe_layer(self, i: int) -> bool:
        if not self.num_experts:
            return False
        if i < self.first_k_dense:
            return False
        return i % self.moe_every == self.moe_offset

    def layer_is_global(self, i: int) -> bool:
        """gemma3-style local:global mix; True = full attention."""
        if self.global_every <= 0:
            return True
        return (i + 1) % self.global_every == 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One workload shape: sequence length, global batch and its kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape.kind == "decode" and model.is_encoder:
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not model.sub_quadratic:
        return "pure full-attention arch; 500k decode skipped per assignment"
    return None

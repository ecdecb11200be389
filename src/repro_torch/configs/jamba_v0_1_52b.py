"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave (attn at position
4 of each 8-layer period), MoE 16 experts top-2 on every other layer.
[arXiv:2403.19887; hf]"""

from repro_torch.configs.base import ModelConfig

_PATTERN = ("mamba", "mamba", "mamba", "attn",
            "mamba", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536, mlp_type="swiglu",
    num_experts=16, num_experts_per_tok=2, d_ff_expert=14336,
    moe_every=2, moe_offset=1, block_pattern=_PATTERN,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=128, mlp_type="swiglu",
        num_experts=4, num_experts_per_tok=2, d_ff_expert=192,
        moe_every=2, moe_offset=1, block_pattern=_PATTERN,
        mamba_d_state=4, mamba_d_conv=4, mamba_expand=2, mamba_chunk=8,
    )

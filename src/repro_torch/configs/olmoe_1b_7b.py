"""olmoe-1b-7b [moe]: 64 experts, top-8, MHA (kv=16). [arXiv:2409.02060; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304, mlp_type="swiglu",
    num_experts=64, num_experts_per_tok=8, d_ff_expert=1024,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="olmoe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=128, mlp_type="swiglu",
        num_experts=8, num_experts_per_tok=2, d_ff_expert=96,
    )

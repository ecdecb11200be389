"""deepseek-moe-16b [moe]: fine-grained 64 routed experts top-6 + 2 shared
experts; first layer dense. [arXiv:2401.06066; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400, mlp_type="swiglu",
    num_experts=64, num_experts_per_tok=6, num_shared_experts=2,
    d_ff_expert=1408, first_k_dense=1,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="deepseek-moe-smoke", family="moe",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=256, vocab_size=128, mlp_type="swiglu",
        num_experts=8, num_experts_per_tok=2, num_shared_experts=1,
        d_ff_expert=48, first_k_dense=1,
    )

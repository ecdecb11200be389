"""granite-34b [dense]: llama-arch code model, MQA (kv=1). [arXiv:2405.04324; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152, mlp_type="swiglu", rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="granite-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=256, vocab_size=128, mlp_type="swiglu",
    )

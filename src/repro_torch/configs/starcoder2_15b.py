"""starcoder2-15b [dense]: GQA kv=4, RoPE, standard (gelu) MLP.
[arXiv:2402.19173; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152, mlp_type="gelu", rope_theta=100_000.0,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="starcoder2-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=128, mlp_type="gelu",
    )

"""internlm2-20b [dense]: GQA kv=8. [arXiv:2403.17297; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92544, mlp_type="swiglu", rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="internlm2-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=128, mlp_type="swiglu",
    )

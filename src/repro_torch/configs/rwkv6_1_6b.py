"""rwkv6-1.6b "Finch" [ssm]: attention-free, data-dependent decay linear
attention + relu^2 ChannelMix. [arXiv:2404.05892; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=7168, vocab_size=65536, mlp_type="relu2",
    rwkv=True, rwkv_head_dim=64,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        num_layers=3, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=224, vocab_size=128, mlp_type="relu2",
        rwkv=True, rwkv_head_dim=16, rwkv_chunk=8,
    )

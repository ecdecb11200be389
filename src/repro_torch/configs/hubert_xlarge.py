"""hubert-xlarge [audio]: encoder-only (bidirectional) backbone over
precomputed frame embeddings; 504 masked-prediction units as the "vocab".
[arXiv:2106.07447; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, mlp_type="gelu", causal=False,
    frontend="audio", frontend_dim=512,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="hubert-smoke", family="audio",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=256, vocab_size=32, mlp_type="gelu", causal=False,
        frontend="audio", frontend_dim=24,
    )

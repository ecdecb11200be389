"""gemma3-27b [dense]: 5:1 local:global attention (window 1024), GQA kv=16,
huge (262k) tied vocab. [hf:google/gemma-3-*-pt; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144, mlp_type="geglu",
    sliding_window=1024, global_every=6, rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=256, mlp_type="geglu",
        sliding_window=8, global_every=3, tie_embeddings=True,
    )

"""qwen2-vl-2b [vlm]: M-RoPE text backbone; vision frontend is a stub
(precomputed patch embeddings). [arXiv:2409.12191; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, mlp_type="swiglu", rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24), frontend="vision", frontend_dim=1280,
    vision_tokens=256, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    """The same architecture at test size: a few layers, narrow widths."""
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        num_layers=3, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=128, mlp_type="swiglu",
        mrope_sections=(2, 3, 3), frontend="vision", frontend_dim=48,
        vision_tokens=8, tie_embeddings=True,
    )

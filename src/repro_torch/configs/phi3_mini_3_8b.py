"""Phi-3-mini 3.8B [arXiv:2404.14219] — RoPE + SwiGLU, 32 KV heads (MHA)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064, rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-smoke", family="dense", n_layers=2, d_model=96,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        compute_dtype="float32",
    )

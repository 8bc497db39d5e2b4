"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — QKV bias, tied embeddings."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=2816, vocab=151936, qkv_bias=True,
        rope_theta=1e6, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=176, vocab=512, qkv_bias=True,
        tie_embeddings=True, compute_dtype="float32",
    )

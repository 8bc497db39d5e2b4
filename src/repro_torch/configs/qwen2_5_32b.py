"""Qwen2.5-32B — dense GQA, QKV bias [family source hf:Qwen/Qwen2.5-0.5B]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=27648, vocab=152064, qkv_bias=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-smoke", family="dense", n_layers=2, d_model=80,
        n_heads=5, n_kv_heads=1, d_ff=216, vocab=512, qkv_bias=True,
        compute_dtype="float32",
    )

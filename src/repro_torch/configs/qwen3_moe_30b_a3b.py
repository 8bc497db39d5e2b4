"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8, qk-norm, hd=128."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=6144, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6, n_experts=128, top_k=8, d_expert=768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=192, vocab=512, head_dim=16,
        qk_norm=True, n_experts=16, top_k=8, d_expert=24,
        compute_dtype="float32",
    )

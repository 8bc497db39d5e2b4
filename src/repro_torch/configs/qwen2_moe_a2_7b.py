"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 4 shared + 60 routed top-4."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=5632, vocab=151936, qkv_bias=True,
        rope_theta=1e6, n_experts=60, top_k=4, d_expert=1408,
        n_shared=4, d_shared=5632,   # 4 shared experts = one 4x1408 SwiGLU
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=176, vocab=512, qkv_bias=True,
        n_experts=8, top_k=4, d_expert=44, n_shared=4, d_shared=176,
        compute_dtype="float32",
    )

"""Jamba v0.1 52B [arXiv:2403.19887] — Mamba+attn 1:7, MoE 16e top-2."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
        n_experts=16, top_k=2, d_expert=14336, moe_every=2, attn_every=8,
        d_state=16, d_conv=4, expand=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke", family="hybrid", n_layers=8, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=224, vocab=512, n_experts=4, top_k=2,
        d_expert=224, moe_every=2, attn_every=8, d_state=8, d_conv=4,
        expand=2, compute_dtype="float32",
    )

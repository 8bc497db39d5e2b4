"""InternVL2-2B [arXiv:2404.16821] — InternLM2-1.8B backbone; InternViT
frontend is a STUB (precomputed patch embeddings via input_specs)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92553, rope_theta=1e6,
        d_frontend=1024, n_frontend_tokens=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, d_frontend=32,
        n_frontend_tokens=8, compute_dtype="float32",
    )

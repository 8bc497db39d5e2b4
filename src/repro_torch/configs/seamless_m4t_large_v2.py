"""SeamlessM4T-large v2 backbone [arXiv:2308.11596] — enc-dec; audio
frontend is a STUB (precomputed frame embeddings via input_specs)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec", n_layers=24,
        n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256206, d_frontend=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke", family="encdec", n_layers=2,
        n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, d_frontend=32, compute_dtype="float32",
    )

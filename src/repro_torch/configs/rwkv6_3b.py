"""RWKV6 "Finch" 3B [arXiv:2404.05892] — attention-free, data-dep decay."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
        n_heads=40, n_kv_heads=40, d_ff=8960, vocab=65536, rwkv_head_dim=64,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=224, vocab=512, rwkv_head_dim=16,
        compute_dtype="float32",
    )

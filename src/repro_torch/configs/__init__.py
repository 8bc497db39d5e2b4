"""Architecture registry: --arch <id> -> ModelConfig (+ reduced smoke)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = {
    "qwen2-moe-a2.7b":       "repro_torch.configs.qwen2_moe_a2_7b",
    "qwen3-moe-30b-a3b":     "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen2.5-32b":           "repro_torch.configs.qwen2_5_32b",
    "phi3-mini-3.8b":        "repro_torch.configs.phi3_mini_3_8b",
    "qwen1.5-0.5b":          "repro_torch.configs.qwen1_5_0_5b",
    "qwen2.5-14b":           "repro_torch.configs.qwen2_5_14b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "internvl2-2b":          "repro_torch.configs.internvl2_2b",
    "rwkv6-3b":              "repro_torch.configs.rwkv6_3b",
    "jamba-v0.1-52b":        "repro_torch.configs.jamba_v0_1_52b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(ARCHS[arch])
    return mod.smoke_config() if smoke else mod.config()


def list_archs():
    return sorted(ARCHS)

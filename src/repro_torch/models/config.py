"""Model configuration shared by all ten architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | encdec | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    compute_dtype: str = "bfloat16"
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0           # per-expert ffn dim
    n_shared: int = 0           # shared experts (qwen2-moe)
    d_shared: int = 0           # shared-expert ffn dim
    moe_every: int = 1          # MoE cadence over layers (jamba: 2)
    router_aux_coef: float = 0.001
    # --- encoder-decoder (seamless) ---
    n_enc_layers: int = 0
    # --- SSM / hybrid ---
    attn_every: int = 0         # jamba: attention at layer i % 8 == 4
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    rwkv_head_dim: int = 64
    # --- VLM / audio stubs ---
    n_frontend_tokens: int = 0  # patch/frame embeddings prepended (stub)
    d_frontend: int = 0         # raw frontend feature dim (projected to d_model)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def d_inner(self) -> int:   # mamba inner dim
        return self.expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        dense_mlp = 3 * d * self.d_ff
        moe_mlp = (self.n_experts * 3 * d * self.d_expert
                   + (3 * d * self.d_shared if self.n_shared else 0)
                   + d * self.n_experts)
        if self.family in ("dense", "vlm"):
            core = self.n_layers * (attn + dense_mlp)
        elif self.family == "moe":
            core = self.n_layers * (attn + moe_mlp)
        elif self.family == "encdec":
            core = (self.n_enc_layers * (attn + dense_mlp)
                    + self.n_layers * (2 * attn + dense_mlp))
        elif self.family == "ssm":   # rwkv6
            tm = 6 * d * d          # r,k,v,w(lora approx),g,out
            cm = 2 * d * int(self.d_ff)
            core = self.n_layers * (tm + cm)
        elif self.family == "hybrid":  # jamba
            di = self.d_inner
            mamba = (2 * d * di + di * d
                     + di * (2 * self.d_state + 1) + di * self.d_conv)
            n_attn = self.n_layers // max(self.attn_every, 1)
            n_moe = self.n_layers // max(self.moe_every, 1)
            n_mamba = self.n_layers - n_attn
            core = (n_attn * attn + n_mamba * mamba
                    + n_moe * moe_mlp
                    + (self.n_layers - n_moe) * dense_mlp)
        else:
            raise ValueError(self.family)
        return emb + core

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        full_moe = self.n_experts * 3 * d * self.d_expert
        act_moe = self.top_k * 3 * d * self.d_expert
        n_moe = (self.n_layers // max(self.moe_every, 1))
        return self.param_count() - n_moe * (full_moe - act_moe)

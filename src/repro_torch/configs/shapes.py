"""The four input-shape sets of the dry run and which archs each applies
to, the counterpart of the JAX package's ``configs/shapes.py``: the same
fields, values and reasons."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """``long_500k`` only for the sub-quadratic families (ssm, hybrid);
    every arch has a decoder, so the other shapes always apply."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "pure full-attention arch: long_500k skipped per spec"
    return True, ""

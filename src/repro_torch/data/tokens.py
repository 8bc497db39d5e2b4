"""Deterministic data pipeline: synthetic LM batches and binary token
files, in the names of the JAX package's ``data/tokens.py``.

Both sources are stateless-resumable: batch t is a pure function of
(seed, step), so a restore at step N reproduces the exact stream.  The
tokens are drawn with numpy exactly as the JAX package draws them (the
same batch for the same seed and step) and handed over as int32 tensors
on the card unless ``device`` names another, copied from pinned memory
without waiting for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import runtime


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str = "synthetic"     # synthetic | file
    path: Optional[str] = None  # uint16/uint32 .bin for kind=file
    vocab: int = 32000
    seed: int = 0


def _to_device(toks: np.ndarray, device: torch.device) -> dict:
    """``tokens`` and ``labels`` (the next token) of (B, S + 1) int32
    windows, on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(toks))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return dict(tokens=t[:, :-1], labels=t[:, 1:])


class SyntheticTokens:
    """Zipf-ish synthetic token stream (harder than uniform for loss
    curves)."""

    def __init__(self, cfg: DataConfig, batch: int, seq: int,
                 host_id: int = 0, num_hosts: int = 1, device=None):
        if batch % num_hosts:
            raise ValueError(f"batch {batch} does not split over "
                             f"{num_hosts} hosts")
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = batch // num_hosts
        self.device = runtime.resolve_device(device)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.cfg.seed, step, self.host_id))
        z = rng.zipf(1.3, size=(self.local_batch, self.seq + 1))
        return _to_device((z % self.cfg.vocab).astype(np.int32), self.device)

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class TokenFile:
    """Memory-mapped flat token file, sharded across hosts by stride."""

    def __init__(self, cfg: DataConfig, batch: int, seq: int,
                 host_id: int = 0, num_hosts: int = 1, dtype=np.uint16,
                 device=None):
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.batch = batch
        self.seq = seq
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = batch // num_hosts
        self.tokens_per_batch = self.local_batch * (seq + 1)
        self.n_windows = max((len(self.data) - 1) // self.tokens_per_batch, 1)
        self.device = runtime.resolve_device(device)

    def batch_at(self, step: int) -> dict:
        w = (step * self.num_hosts + self.host_id) % self.n_windows
        start = w * self.tokens_per_batch
        chunk = np.asarray(
            self.data[start:start + self.tokens_per_batch + 1])
        if chunk.size < self.tokens_per_batch + 1:
            chunk = np.pad(chunk,
                           (0, self.tokens_per_batch + 1 - chunk.size))
        toks = chunk[:self.tokens_per_batch].reshape(
            self.local_batch, self.seq + 1).astype(np.int32)
        return _to_device(toks, self.device)


def make_dataset(cfg: DataConfig, batch: int, seq: int, **kw):
    if cfg.kind == "synthetic":
        return SyntheticTokens(cfg, batch, seq, **kw)
    if cfg.kind == "file":
        return TokenFile(cfg, batch, seq, **kw)
    raise ValueError(cfg.kind)

"""Collectives over the shard axis, and the compressed MST reduction.

A per-shard tensor carries the shard axis as its first dimension (S rows);
a replicated one is held once (:mod:`repro_torch.sharding.mesh`).  Each
function here computes what the JAX package's collective computes under
``shard_map`` (``src/repro/sharding/collectives.py`` and ``jax.lax``):

* :func:`pmin`, :func:`pmax`, :func:`psum` reduce the stacked rows to the
  one replicated result;
* :func:`all_to_all` swaps the shard and destination dimensions: row d of
  the result holds what every shard s sent to d, in the order s = 0..S-1;
* :func:`ppermute_ring` sends row i to row i + 1 (mod S);
* :func:`pmin_compressed` is the message-compressed ``pmin`` of the
  Borůvka engines: each shard packs the entries where it differs from the
  baseline into a ``cap``-entry packet of ``(int32 index, value)`` pairs,
  the packets travel the ring for S - 1 steps, and every shard
  scatter-mins every other shard's packet once.  Min is order-free, so the
  result equals :func:`pmin` bit for bit; if any shard holds more than
  ``cap`` entries, an overflow flag (a :func:`pmax`) sends the whole call
  through the dense :func:`pmin`, as the reference's ``lax.cond`` does.
  Both branches are computed on the device and one is selected there, so
  the call never waits for the host.

:func:`compressed_bytes` and :func:`dense_bytes` are the reference's wire
model of one exchange, per shard.  Values are compared in the port's
flipped form (``core/keys.py``), whose signed order is the reference's
unsigned order.

:func:`compress_tree` is the training step's bf16 gradient compression
with error feedback.  The reference's ``latency_hiding_flags`` (XLA
scheduler flags) have no counterpart on one card; overlapping the
gradients' exchange with the backward comes with shards on several cards
(ROADMAP queue 1, item 13b).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

COLLECTIVES = ("pmin", "compressed")

# Wire format of one candidate entry: int32 index lane + the value lane.
INDEX_BYTES = 4
FLT_MIN = 2.0 ** -126           # the smallest normal float32


def resolve_collective(collective: str) -> str:
    """Validate the shared ``params.collective`` knob."""
    if collective not in COLLECTIVES:
        raise ValueError(
            f"unknown collective {collective!r}; options: {COLLECTIVES}")
    return collective


def pmin(x: torch.Tensor) -> torch.Tensor:
    """Elementwise min over the shard rows of ``x`` (S, ...)."""
    return x.amin(0)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the shard rows of ``x`` (S, ...)."""
    return x.amax(0)


def psum(x: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the shard rows of ``x`` (S, ...), in its dtype."""
    return x.sum(0, dtype=x.dtype)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``x[s, d, ...]`` (shard s's block for shard d) to ``y[d, s, ...]``:
    ``lax.all_to_all`` with split and concat axis 0."""
    return x.transpose(0, 1).contiguous()


def ppermute_ring(x: torch.Tensor) -> torch.Tensor:
    """Row i moves to row (i + 1) mod S (``ppermute`` over the ring)."""
    return torch.roll(x, 1, 0)


def pmin_compressed(x: torch.Tensor, *, default, cap: int,
                    num_shards: int) -> torch.Tensor:
    """Elementwise min over the shard rows of ``x`` (S, n), exchanging only
    the entries where a shard differs from ``default`` (a scalar, or an
    (n,) baseline every shard shares).  Returns the replicated (n,) result,
    equal to :func:`pmin` bit for bit when no shard contributes a value
    above the baseline (the engines' keys and hook parents only improve
    on it).

    The packets are built on every shard (index sentinel ``n``: out of
    range, so an unused slot scatters nowhere), and the ring runs as shard
    0 sees it: at step t it receives the packet shard S - t built, forwarded
    t times, and scatter-mins it into its own row.  Every shard ends with
    the same values, so one is held.
    """
    if num_shards <= 1:
        return x[0]
    S, n = x.shape
    dev = x.device
    has = x != default
    count = has.sum(1)
    overflow = pmax((count > cap).to(torch.int32)) > 0
    pos = torch.cumsum(has, 1) - 1
    idx = torch.where(has & (pos < cap), pos, cap)   # cap: the dropped slot
    frag = torch.full((S, cap + 1), n, dtype=torch.int64, device=dev)
    frag.scatter_(1, idx, torch.arange(n, device=dev).expand(S, n))
    val = torch.zeros((S, cap + 1), dtype=x.dtype, device=dev)
    val.scatter_(1, idx, x)
    frag, val = frag[:, :cap], val[:, :cap]
    acc = torch.cat([x[0], x.new_zeros(1)])          # slot n: dropped
    for _ in range(num_shards - 1):
        frag = ppermute_ring(frag)
        val = ppermute_ring(val)
        acc.scatter_reduce_(0, frag[0], val[0], "amin")
    return torch.where(overflow, pmin(x), acc[:n])


def compressed_bytes(cap: int, num_shards: int, value_bytes: int) -> int:
    """Per-shard on-wire bytes of ONE compressed exchange: ``num_shards-1``
    ring steps each forwarding a ``cap``-entry packet."""
    if num_shards <= 1:
        return 0
    return (num_shards - 1) * cap * (INDEX_BYTES + value_bytes)


def dense_bytes(n: int, num_shards: int, value_bytes: int) -> int:
    """Per-shard on-wire bytes of one full-width ``pmin`` over a replicated
    length-``n`` array, under the bandwidth-optimal reduce-scatter +
    all-gather model: ``2·(P-1)/P · n`` values."""
    if num_shards <= 1:
        return 0
    return int(2 * (num_shards - 1) * n * value_bytes // num_shards)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values as zeros of their sign (ROADMAP hazard
    H16): XLA reads and writes float32 with denormals flushed on the CPU
    (DAZ and FTZ), as the TPU does, and PyTorch keeps them."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def compress_tree(grads: Mapping[str, torch.Tensor],
                  residual: Optional[Mapping[str, torch.Tensor]]):
    """bf16 compression with error feedback: each gradient plus its float32
    residual (zeros when ``residual`` is None), rounded to bf16 (to nearest
    even, as ``astype`` rounds), and what the rounding dropped as the next
    residual.  Subnormal gradients, residuals, sums and new residuals are
    zeros of their sign, as the reference computes them (:func:`_flush`).
    Returns ``(compressed, residual)``, two dicts of ``grads``' keys."""
    comp, res = {}, {}
    for name, g in grads.items():
        # + 0.0 as the reference adds its zeros: -0.0 becomes +0.0
        gf = _flush(_flush(g.float()) + (0.0 if residual is None
                                         else _flush(residual[name])))
        comp[name] = gf.to(torch.bfloat16)
        res[name] = _flush(gf - comp[name].float())
    return comp, res

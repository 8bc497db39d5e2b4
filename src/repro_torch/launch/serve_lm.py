"""Batched LM serving driver: prefill a prompt batch, decode N tokens a
request, for every family: dense transformers (Qwen, Phi-3), MoE
transformers (Qwen2-MoE, Qwen3-MoE), the VLM (InternVL2), the
encoder–decoder (SeamlessM4T), RWKV6 and Jamba.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen1.5-0.5b \
        --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch rwkv6-3b \
        --batch 8 --prompt-len 1024 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \
        --arch qwen2-moe-a2.7b --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \
        --arch seamless-m4t-large-v2 --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \
        --arch internvl2-2b --batch 8 --prompt-len 1024 --gen 32

The stub frontends' inputs come from ``synth_batch`` with the prompts: the
encoder–decoder encodes ``--prompt-len`` frames, and the VLM puts its
``n_frontend_tokens`` patch embeddings before the prompt.

Jamba v0.1 in full (51.4 B parameters, about 103 GB in bf16) does not fit
one 80 GB card; :func:`serve` takes a config with its depth cut, one
superblock of 8 layers at full width::

    serve(dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8),
          batch=8, prompt_len=1024, gen=32)

It runs on the CUDA card, and raises without one, unless ``--device``
names another device: ``--device cpu`` runs the kernels' plain PyTorch
versions.  Weights are random, from ``--seed``.  On the card the decode
loop runs under ``torch.cuda.set_sync_debug_mode("error")``: a step that
waited for the device would raise.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core import runtime
from repro_torch.models.api import get_model, synth_batch
from repro_torch.models.config import ModelConfig
from repro_torch.train.serve_step import (
    SAMPLERS, make_decode_step, make_prefill_step)


@dataclasses.dataclass
class ServeResult:
    seqs: torch.Tensor              # (B, gen) int32: the generated tokens
    prefill_s: float                # prompt -> first token, host clock
    decode_s: float                 # the gen - 1 decode steps, host clock
    decode_tokens_per_s: float      # B * (gen - 1) / decode_s
    logits_finite: bool             # every logit of every step was finite
    device: str


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _no_host_sync(dev: torch.device):
    """Raise at any operation that waits for the card (CUDA only)."""
    if dev.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
          sample: str = "greedy", seed: int = 0, device=None) -> ServeResult:
    """Random weights and prompts from ``seed``; prefill, then ``gen - 1``
    decode steps.  The first token is the prefill logits' argmax."""
    if gen < 1:
        raise ValueError("gen must be at least 1")
    dev = runtime.resolve_device(device)
    model = get_model(cfg)
    generator = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(generator, cfg)
    max_len = prompt_len + gen
    prompts = synth_batch(seed, cfg, batch, prompt_len, device=dev)
    prefill = make_prefill_step(cfg, max_len=max_len)
    decode = make_decode_step(cfg, sample=sample)

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill(params, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    nxt = logits[:, -1].float().argmax(dim=-1).to(torch.int32)[:, None]
    toks = [nxt]
    finite = torch.isfinite(logits).all()
    t0 = time.perf_counter()
    with _no_host_sync(dev):
        for _ in range(gen - 1):
            nxt, state, logits = decode(params, state, nxt, generator)
            finite = finite & torch.isfinite(logits).all()
            toks.append(nxt)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return ServeResult(
        seqs=torch.cat(toks, dim=1), prefill_s=t_prefill, decode_s=t_dec,
        decode_tokens_per_s=batch * (gen - 1) / max(t_dec, 1e-9),
        logits_finite=bool(finite),
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else str(dev)))


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sample", default="greedy", choices=SAMPLERS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, sample=args.sample, seed=args.seed,
                device=args.device)
    print(f"device: {res.device}")
    print(f"prefill: {args.batch}x{args.prompt_len} in {res.prefill_s:.2f}s "
          f"({args.batch * args.prompt_len / max(res.prefill_s, 1e-9):.0f} "
          f"tok/s)")
    print(f"decode:  {args.gen - 1} steps in {res.decode_s:.2f}s "
          f"({res.decode_tokens_per_s:.1f} tok/s)")
    print("sample tokens:", res.seqs[0, :16].cpu().numpy())
    return res


if __name__ == "__main__":
    main()

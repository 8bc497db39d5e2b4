"""End-to-end training driver, the port of the JAX package's
``launch/train.py``: on the card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --smoke --steps 50 --batch 8 --seq 256 --device cpu --ckpt-dir DIR

Fault tolerance: periodic atomic checkpoints, a final save on SIGTERM
(preemption), and ``--resume``, which restores the parameters, the
optimizer and the data cursor (the step).  Only the steps that log read
the device from the host.  ``--mesh`` other than 1x1 waits for shards on
several cards (ROADMAP queue 1, item 13b).

The data source gives token batches only, as the JAX package's launcher
does: the vlm family trains here without its patch prefix, and the encdec
family, whose loss reads ``frame_embeds``, trains through
``train_step.make_train_step`` on ``models.api.synth_batch`` batches,
which carry the stub frontends' embeddings.
"""
from __future__ import annotations

import argparse
import signal
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config, list_archs
from repro_torch.core import runtime
from repro_torch.data.tokens import DataConfig, make_dataset
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                          make_train_step)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int,
                    default=opt_lib.AdamWConfig.warmup_steps)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM devices; only 1x1 is ported")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the card unless named (e.g. cpu)")
    return ap.parse_args(argv)


def main(argv=None, *, on_step: Optional[Callable] = None):
    """Train as the flags say; returns the final train state.  ``on_step``,
    if given, is called as ``on_step(step, state, metrics)`` at the end of
    each step, after its log line and checkpoint (``step`` counted from 1;
    ``metrics`` device scalars)."""
    args = parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    if d * m != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: training over several devices waits for "
            f"shards on several cards (ROADMAP queue 1, item 13b)")
    cfg = get_config(args.arch, smoke=args.smoke)
    device = runtime.resolve_device(args.device)
    hp = TrainHParams(
        remat=args.remat, grad_accum=args.grad_accum,
        adamw=opt_lib.AdamWConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                                  compress_grads=args.compress_grads))
    step_fn = make_train_step(cfg, hp)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(gen, cfg)
    start_step = 0
    if args.resume and args.ckpt_dir:
        last = ckpt_lib.latest_step(args.ckpt_dir)
        if last is not None:
            if args.compress_grads:    # the template holds the residual
                state["grad_residual"] = {
                    n: torch.zeros_like(p) for n, p in
                    state["params"].named_parameters()}
            state, meta = ckpt_lib.restore(args.ckpt_dir, state, step=last)
            start_step = meta["step"]
            print(f"resumed from step {start_step}", flush=True)

    data = make_dataset(
        DataConfig(kind=args.data, path=args.data_path, vocab=cfg.vocab,
                   seed=args.seed), args.batch, args.seq, device=device)

    stop = {"flag": False}

    def on_term(signum, frame):
        print("SIGTERM: saving and exiting", flush=True)
        stop["flag"] = True

    previous = signal.signal(signal.SIGTERM, on_term)
    try:
        t0 = time.time()
        for step in range(start_step, args.steps):
            state, metrics = step_fn(state, data.batch_at(step))
            if (step + 1) % args.log_every == 0 or step == start_step:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                dt = time.time() - t0
                tok_s = args.batch * args.seq * (step + 1 - start_step) / dt
                print(f"step {step + 1:5d} loss {loss:7.4f} "
                      f"gnorm {gn:8.3f} tok/s {tok_s:9.0f}", flush=True)
            if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                                  or stop["flag"]
                                  or step + 1 == args.steps):
                ckpt_lib.save(args.ckpt_dir, step + 1, state)
            if on_step is not None:
                on_step(step + 1, state, metrics)
            if stop["flag"]:
                break
    finally:
        signal.signal(signal.SIGTERM, previous)
    print("training done", flush=True)
    return state


if __name__ == "__main__":
    main()

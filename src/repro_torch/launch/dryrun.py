"""Dry run of every (arch × shape) on the production meshes, the
counterpart of the JAX package's ``launch/dryrun.py``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh both --out DIR

Each cell builds its model and state on ``meta`` tensors at the arch's
full config and runs one step under ``launch/flops.CostCounter``: a train
step (remat ``full``, microbatches by the JAX package's formula), a
prefill of the whole prompt, or one decode step on a state whose caches
stand at ``cache_len - 1``.  A ``meta`` tensor has a shape and a type and
no storage, so the run allocates nothing and computes nothing, and the
counts are exact integers, equal to the counts of the same step on the
CPU or the card.  The kernels' entries return empty outputs on ``meta``
and are charged by their one rule (``launch/flops.py``).  The dry run is
the one entry point that needs no card; it never falls back to another
device.  It times nothing.

The JAX dry run compiles each cell for a TPU mesh of 256 or 512 devices
forced on the host.  Here each mesh is a ``DeviceMesh`` over a fake
process group of that many ranks in this process (``launch/mesh.py``),
and the rules of ``sharding/specs.py`` place every parameter of the step
and its state on it as DTensor placements; each rank's bytes are those of
the local shards.  The decode state is placed as the JAX package's
``decode_state_shardings`` places it: the KV sequence over ``model``, the
batch over the batch axes where it divides.

Each cell writes ``{arch}__{shape}__{mesh}.json`` with the JAX record's
fields: ``arch``, ``shape``, ``mesh``, ``status`` (``ok``, ``skip`` or
``fail``) and ``reason``; for ``ok``, ``n_devices``, ``model_flops``,
``tokens``, ``jaxpr_flops_global`` and ``jaxpr_bytes_global`` (the
counter's ``flops`` and ``bytes`` of the whole step), and ``memory``: per
rank, ``argument_bytes`` and ``output_bytes`` of the step's inputs and
outputs as the rules place them, and ``param_bytes``, ``grad_bytes`` and
``opt_bytes`` (train) or ``param_bytes`` and ``state_bytes`` (prefill,
decode).  Beside them ``counted_matmul_flops``, the counter's
``kernels`` charges, and ``grad_accum`` (train).  The fields with no
counterpart here are ``null``:

* ``lower_s`` and ``compile_s``: there is no lowering and no compiler,
  and the dry run times nothing;
* ``flops_per_device`` and ``bytes_per_device``: the compiler's cost of
  the partitioned program; no program is partitioned here (the global
  counts over ``n_devices`` are the even split);
* ``collectives``: no sharded program runs until shards on several cards
  (ROADMAP queue 1, item 13b);
* ``memory.temp_bytes`` and ``memory.peak_bytes``: the compiler's buffer
  assignment.

``jaxpr_unbounded_whiles`` is 0: every loop of the port runs its trips
under the counter, so none is counted once for an unknown trip count.
A cell that fails is a ``fail`` record with its traceback, and the exit
code is 1.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import flops
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     make_rules)
from repro_torch.models import api, convert
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.specs import (ShardingRules, axis_size,
                                        param_specs, placements)
from repro_torch.train import optimizer as opt
from repro_torch.train.serve_step import (decode_input_specs,
                                          make_decode_step,
                                          make_prefill_step)
from repro_torch.train.train_step import TrainHParams, make_train_step

# mesh tag -> (ranks, multi_pod)
MESHES = {"pod16x16": (256, False), "multipod2x16x16": (512, True)}
MESH_CHOICES = {"single": ("pod16x16",), "multi": ("multipod2x16x16",),
                "both": ("pod16x16", "multipod2x16x16")}


def meta_model(cfg: ModelConfig, master=None):
    """The port's model of ``cfg`` on ``meta``: float32 masters that
    require grad with ``master=torch.float32``, else the serving model."""
    cls, _ = convert.MODELS[cfg.family]
    kw = dict(master=master) if master is not None else {}
    return cls(cfg, device="meta", **kw)


def meta_train_state(cfg: ModelConfig) -> dict:
    """``train_step.init_train_state``'s state on ``meta``."""
    model = meta_model(cfg, torch.float32)
    return dict(params=model, opt=opt.init(dict(model.named_parameters())))


def grad_accum(cfg: ModelConfig, shape, mesh, rules: ShardingRules) -> int:
    """Microbatches of a train cell (the JAX dry run's formula): at most
    16,384 tokens a batch rank a microbatch, and at least 8 microbatches
    above 40 B parameters and for the ssm family."""
    n_dev_batch = axis_size(mesh, rules.batch)
    tokens_per_dev = shape.global_batch * shape.seq_len // max(n_dev_batch,
                                                               1)
    accum = max(1, tokens_per_dev // 16384)
    if cfg.param_count() > 4e10:
        accum = max(accum, 8)
    if cfg.family == "ssm":       # recurrent scan residuals are f32-heavy
        accum = max(accum, 8)
    return accum


def batch_axes_or_none(mesh, rules: ShardingRules, dim: int):
    ax = rules.batch
    return ax if dim % axis_size(mesh, ax) == 0 else None


def batch_bytes(tensors, mesh, rules: ShardingRules) -> int:
    """Rank 0's bytes of batch-major tensors: each one's leading dim over
    the batch axes where it divides, the others replicated."""
    return placed_bytes([(t, (batch_axes_or_none(mesh, rules, t.shape[0]),)
                          + (None,) * (t.ndim - 1)) for t in tensors], mesh)


def decode_state_specs(cfg: ModelConfig, state, mesh, rules: ShardingRules,
                       batch: int) -> dict:
    """{name: (tensor, spec)} of a decode state (the JAX package's
    ``decode_state_shardings``): KV caches (L, B, Hkv, S, hd) with S over
    the model axis where it divides and B over the batch axes; RWKV6's
    shift tokens with d over the model axis, its WKV state by batch;
    Jamba's Mamba states with d_inner over the model axis.  A cache's
    ``index`` is a host int and takes no device bytes."""
    ba = batch_axes_or_none(mesh, rules, batch)
    model = rules.model

    def over_model(dim):
        return model if model and dim % axis_size(mesh, model) == 0 else None

    def kv(t):
        return t, (None, ba, None, over_model(t.shape[3]), None)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return dict(k=kv(state.k), v=kv(state.v))
    if fam == "encdec":
        cache, (ck, cv) = state
        return dict(k=kv(cache.k), v=kv(cache.v), cross_k=kv(ck),
                    cross_v=kv(cv))
    if fam == "ssm":
        dm = over_model(cfg.d_model)
        return dict(tm=(state.tm, (None, ba, dm)),
                    cm=(state.cm, (None, ba, dm)),
                    wkv=(state.wkv, (None, ba, None, None, None)))
    if fam == "hybrid":
        dm = over_model(cfg.d_inner)
        return dict(conv=(state.conv, (None, None, ba, None, dm)),
                    ssm=(state.ssm, (None, None, ba, dm, None)),
                    k=kv(state.k), v=kv(state.v))
    raise ValueError(fam)


def placed_bytes(tensors, mesh) -> int:
    """Rank 0's bytes of ``(tensor, spec)`` pairs placed on ``mesh``: each
    tensor's local shard under :func:`~repro_torch.sharding.specs.
    placements`."""
    from torch.distributed.tensor import distribute_tensor
    local: dict = {}        # layers repeat (shape, type, spec): place once
    total = 0
    for t, spec in tensors:
        key = (tuple(t.shape), t.dtype, tuple(spec))
        if key not in local:
            shard = distribute_tensor(
                torch.empty(key[0], dtype=t.dtype, device="meta"), mesh,
                placements(spec, mesh)).to_local()
            local[key] = shard.numel() * shard.element_size()
        total += local[key]
    return total


def placed_params(model, mesh, rules: ShardingRules) -> list:
    """(parameter, spec) pairs of ``model`` under the rules on ``mesh``,
    for :func:`placed_bytes`."""
    specs = param_specs(model, rules, mesh)
    return [(p, specs[n]) for n, p in model.named_parameters()]


def _counted(fn, *args):
    with flops.CostCounter() as counter:
        out = fn(*args)
    return out, counter.result()


def _cost_fields(cost: dict) -> dict:
    return dict(jaxpr_flops_global=cost["flops"],
                jaxpr_bytes_global=cost["bytes"],
                jaxpr_unbounded_whiles=0,
                counted_matmul_flops=cost["matmul_flops"],
                kernels=cost["kernels"])


def count_train(cfg, shape, mesh, rules) -> dict:
    accum = grad_accum(cfg, shape, mesh, rules)
    step = make_train_step(cfg, TrainHParams(remat="full", grad_accum=accum))
    state = meta_train_state(cfg)
    batch = api.train_input_specs(cfg, shape.global_batch, shape.seq_len)
    (_, metrics), cost = _counted(step, state, batch)
    specs = param_specs(state["params"], rules, mesh)
    param_b = placed_bytes(placed_params(state["params"], mesh, rules),
                           mesh)
    opt = state["opt"]       # m and v placed as their parameters
    opt_b = placed_bytes([(t, specs[n]) for part in ("m", "v")
                          for n, t in opt[part].items()]
                         + [(opt["step"], ())], mesh)
    batch_b = batch_bytes(batch.values(), mesh, rules)
    metric_b = placed_bytes([(t, ()) for t in metrics.values()], mesh)
    tokens = shape.global_batch * shape.seq_len
    return dict(
        # 6·N_active·D counts fwd+bwd (2N fwd + 4N bwd per token)
        model_flops=6 * cfg.active_param_count() * tokens, tokens=tokens,
        grad_accum=accum,
        memory=dict(argument_bytes=param_b + opt_b + batch_b,
                    output_bytes=param_b + opt_b + metric_b,
                    temp_bytes=None, peak_bytes=None,
                    param_bytes=param_b, grad_bytes=param_b,
                    opt_bytes=opt_b),
        **_cost_fields(cost))


def count_prefill(cfg, shape, mesh, rules) -> dict:
    model = meta_model(cfg)
    batch = api.train_input_specs(cfg, shape.global_batch, shape.seq_len)
    batch.pop("labels")
    with torch.no_grad():
        (logits, state), cost = _counted(
            make_prefill_step(cfg, max_len=shape.seq_len), model, batch)
    ba = batch_axes_or_none(mesh, rules, shape.global_batch)
    vdiv = cfg.vocab % axis_size(mesh, rules.model) == 0
    logits_spec = (ba, None, rules.model if vdiv else None)
    param_b = placed_bytes(placed_params(model, mesh, rules), mesh)
    state_b = placed_bytes(decode_state_specs(
        cfg, state, mesh, rules, shape.global_batch).values(), mesh)
    batch_b = batch_bytes(batch.values(), mesh, rules)
    tokens = shape.global_batch * shape.seq_len
    return dict(
        model_flops=2 * cfg.active_param_count() * tokens, tokens=tokens,
        memory=dict(argument_bytes=param_b + batch_b,
                    output_bytes=placed_bytes([(logits, logits_spec)], mesh)
                    + state_b,
                    temp_bytes=None, peak_bytes=None,
                    param_bytes=param_b, state_bytes=state_b),
        **_cost_fields(cost))


def count_decode(cfg, shape, mesh, rules) -> dict:
    model = meta_model(cfg)
    state, tokens_in = decode_input_specs(cfg, shape.global_batch,
                                          shape.seq_len)
    placed = decode_state_specs(cfg, state, mesh, rules, shape.global_batch)
    state_b = placed_bytes(placed.values(), mesh)
    step = make_decode_step(cfg)
    with torch.no_grad():
        (nxt, _, _), cost = _counted(step, model, state, tokens_in)
    param_b = placed_bytes(placed_params(model, mesh, rules), mesh)
    tokens = shape.global_batch      # one token a sequence a step
    return dict(
        model_flops=2 * cfg.active_param_count() * tokens, tokens=tokens,
        memory=dict(argument_bytes=param_b + state_b
                    + batch_bytes([tokens_in], mesh, rules),
                    output_bytes=batch_bytes([nxt], mesh, rules) + state_b,
                    temp_bytes=None, peak_bytes=None,
                    param_bytes=param_b, state_bytes=state_b),
        **_cost_fields(cost))


COUNT_BY_KIND = {"train": count_train, "prefill": count_prefill,
                 "decode": count_decode}


def run_cell(arch: str, shape_name: str, mesh, rules: ShardingRules,
             mesh_tag: str, out_dir: str) -> dict:
    """Count one cell on ``mesh`` and write its record to ``out_dir``;
    returns the record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_tag,
               status="skip", reason=why)
    if ok:
        try:
            counts = COUNT_BY_KIND[shape.kind](cfg, shape, mesh, rules)
            rec.update(status="ok", reason="", lower_s=None, compile_s=None,
                       n_devices=mesh.size(), flops_per_device=None,
                       bytes_per_device=None, collectives=None, **counts)
        except Exception as e:  # noqa: BLE001 -- record and continue
            rec.update(status="fail", reason=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _line(rec: dict) -> str:
    line = (f"[{rec['mesh']}] {rec['arch']:24s} {rec['shape']:12s} "
            f"{rec['status']:5s}")
    if rec["status"] == "ok":
        nd, mem = rec["n_devices"], rec["memory"]
        line += (f" flops/dev={rec['jaxpr_flops_global'] / nd:.3e} "
                 f"matmul={rec['counted_matmul_flops']} "
                 f"args/dev={mem['argument_bytes'] / 2 ** 30:6.2f}GiB")
    elif rec["status"] == "fail":
        line += f"  {rec['reason'][:120]}"
    else:
        line += f"  ({rec['reason'][:60]})"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=sorted(MESH_CHOICES))
    ap.add_argument("--out", default="dryrun_out")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    failures = 0
    for mesh_tag in MESH_CHOICES[args.mesh]:
        ranks, multi_pod = MESHES[mesh_tag]
        with fake_world(ranks):
            mesh = make_production_mesh(multi_pod=multi_pod)
            rules = make_rules(mesh)
            for arch in archs:
                for shape_name in shapes:
                    rec = run_cell(arch, shape_name, mesh, rules, mesh_tag,
                                   args.out)
                    failures += rec["status"] == "fail"
                    print(_line(rec), flush=True)
    print(f"dryrun complete; failures={failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

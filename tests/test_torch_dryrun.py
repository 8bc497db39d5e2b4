"""The dry run (``launch/dryrun.py``) and what it stands on, on the CPU:
counts on ``meta`` tensors, the kernels' ``meta`` branch, the decode
inputs, the decode-state placements and the cell records, held against
the CPU and the JAX package.

* For each of the ten smoke configs, a train step (remat ``none``), a
  prefill and a decode step count the same ``flops``, ``matmul_flops``,
  ``bytes`` and per-kernel charges on ``meta`` as on CPU tensors, as exact
  integers.  They run in float32, except the two MoE archs and Jamba:
  PyTorch's ``meta`` function of ``torch._grouped_mm`` takes bf16 only, so
  those run in bf16 (``compute_dtype="bfloat16"``) on both sides, and
  Qwen2-MoE's ``d_expert`` is widened from 44 to 48, since a grouped
  product needs 16-byte rows (44 bf16 values are 88 bytes; hazard H11).
* Qwen1.5-0.5B's full config under remat ``full`` at batch 8, seq 1,024
  counts 32,976,758,898,688 matmul FLOPs on ``meta``: the count the card
  gave for the same step (``PERF.md`` §6, phase 9b).
* K6-K9 on ``meta`` return empty outputs of their plain versions' shapes
  and types and launch nothing; K1-K5 and the GHS interval kernel still
  raise there.
* ``decode_input_specs`` equals the JAX package's, in shapes and dtypes,
  for every arch; ``decode_state_specs`` equals the JAX package's
  ``decode_state_shardings`` on both production meshes.
* The per-rank parameter bytes from the DTensor placements equal the JAX
  rules' shards of the JAX leaves.
* ``run_cell`` writes the JAX record's keys; ``long_500k`` is ``skip``
  with the JAX reason for a dense arch; a failing cell makes the CLI
  exit 1.
"""
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import generators, ghs_state
from repro_torch.core.params import GHSParams
from repro_torch.kernels.decode_attention import decode_attention as k7
from repro_torch.kernels.edge_hash import edge_hash as k5
from repro_torch.kernels.edge_hash import ops as hash_ops
from repro_torch.kernels.flash_attention import flash_attention as k6
from repro_torch.kernels.ghs_superstep import ghs_superstep
from repro_torch.kernels.ghs_superstep import ref as step_ref
from repro_torch.kernels.mamba_scan import mamba_scan as k8
from repro_torch.kernels.rwkv6 import wkv6 as k9
from repro_torch.kernels.segment_min import segment_min as k14
from repro_torch.kernels.spmv_minplus import spmv_minplus as k23
from repro_torch.launch import dryrun, flops
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import api
from repro_torch.train import serve_step
from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                          make_train_step)

B, S, GEN = 2, 32, 2
GROUPED = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b")
MESH_AXES = {"pod16x16": {"data": 16, "model": 16},
             "multipod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's configs, models, serving steps, rules and dry run,
    imported for this module only (the ``jax.experimental.enable_x64`` name
    is installed for the import and removed again with the ``repro``
    modules on teardown; hazard H1).  The JAX dry run sets ``XLA_FLAGS``
    when it is imported; it is imported after ``jax.devices()`` has run, so
    the flag changes nothing, and ``XLA_FLAGS`` is put back at once."""
    import jax
    import jax.experimental
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    flags = os.environ.get("XLA_FLAGS")
    try:
        jax.devices()
        from repro import configs
        from repro.launch import dryrun as rdryrun
        from repro.launch import mesh as rmesh
        from repro.models import api as rapi
        from repro.sharding import specs as rspecs
        from repro.train import serve_step as rserve
        yield types.SimpleNamespace(
            jax=jax, configs=configs, dryrun=rdryrun, mesh=rmesh, api=rapi,
            specs=rspecs, serve=rserve)
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
        if shimmed:
            del jax.experimental.enable_x64
        for name in _repro_modules():
            del sys.modules[name]
        sys.modules.update(saved)


def _smoke(arch):
    """The smoke config, in bf16 where ``_grouped_mm`` runs (with
    Qwen2-MoE's expert width 48)."""
    cfg = get_config(arch, smoke=True)
    if arch in GROUPED:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    if arch == "qwen2-moe-a2.7b":
        cfg = dataclasses.replace(cfg, d_expert=48)
    return cfg


def _count(step, cfg, device):
    """One step's cost: (train) a step under remat ``none`` on a fresh
    state and a batch; (prefill) a prefill of the prompt; (decode) one
    decode step on a state of S + GEN positions standing at S + GEN - 1.
    On ``meta`` the inputs are the dry run's; on the CPU the same shapes
    with weights and tokens from seed 0."""
    meta = device == "meta"
    if step == "train":
        state = (dryrun.meta_train_state(cfg) if meta else
                 init_train_state(torch.Generator().manual_seed(0), cfg))
        batch = (api.train_input_specs(cfg, B, S) if meta else
                 api.synth_batch(0, cfg, B, S, device="cpu"))
        return flops.cost_of(make_train_step(cfg, TrainHParams("none")),
                             state, batch)
    model = (dryrun.meta_model(cfg) if meta else api.get_model(cfg).init(
        torch.Generator().manual_seed(0), cfg))
    with torch.no_grad():
        if step == "prefill":
            batch = (api.train_input_specs(cfg, B, S) if meta else
                     api.synth_batch(0, cfg, B, S, device="cpu"))
            batch.pop("labels")
            return flops.cost_of(serve_step.make_prefill_step(
                cfg, max_len=S), model, batch)
        if meta:
            state, tokens = serve_step.decode_input_specs(cfg, B, S + GEN)
        else:
            state = api.get_model(cfg).make_decode_state(cfg, B, S + GEN,
                                                         device="cpu")
            cache = state[0] if cfg.family == "encdec" else state
            if hasattr(cache, "index"):
                cache.index = S + GEN - 1
            tokens = torch.zeros((B, 1), dtype=torch.int32)
        return flops.cost_of(serve_step.make_decode_step(cfg), model, state,
                             tokens)


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list_archs())
def test_meta_counts_equal_cpu(arch, step):
    cfg = _smoke(arch)
    before = dict(kernels.LAUNCHES)
    got = _count(step, cfg, "meta")
    want = _count(step, cfg, "cpu")
    assert kernels.LAUNCHES == before
    assert got == want
    assert got["matmul_flops"] > 0
    # RWKV6's decode step is plain tensor code; every other step has a kernel
    assert bool(got["kernels"]) == (cfg.family != "ssm" or step != "decode")


def test_full_qwen_step_counts_as_the_card():
    cfg = get_config("qwen1.5-0.5b")
    state = dryrun.meta_train_state(cfg)
    cost = flops.cost_of(make_train_step(cfg, TrainHParams(remat="full")),
                         state, api.train_input_specs(cfg, 8, 1024))
    assert cost["matmul_flops"] == 32_976_758_898_688
    assert cost["kernels"]["flash_attention"]["calls"] == 2 * cfg.n_layers


# --------------------------------------------------------------------------
# the kernels on meta
# --------------------------------------------------------------------------

def _model_kernel(name, dtype):
    """(entry, CPU args, kwargs) of K6-K9 at a small shape."""
    g = torch.Generator().manual_seed(1)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=g).to(dt)

    if name == "K6":
        return k6.flash_attention, (rand(2, 4, 24, 16), rand(2, 2, 24, 16),
                                    rand(2, 2, 24, 16)), {}
    if name == "K7":
        return k7.decode_attention, (
            rand(2, 4, 16), rand(2, 2, 40, 16), rand(2, 2, 40, 16),
            torch.tensor([7, 40], dtype=torch.int32)), {}
    if name == "K8":
        x, dt = rand(2, 12, 24), rand(2, 12, 24).abs() * 0.1
        return k8.selective_scan, (
            x, dt, rand(2, 12, 8), rand(2, 12, 8),
            -rand(24, 8, dt=torch.float32).abs(),
            rand(24, dt=torch.float32)), {"return_state": True}
    w = torch.rand((3, 12, 16), generator=g).to(dtype) * 0.5 + 0.4
    return k9.wkv6, (rand(3, 12, 16), rand(3, 12, 16), rand(3, 12, 16), w,
                     rand(3, 16)), {"return_state": True}


def _to_meta(args):
    return tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["K6", "K7", "K8", "K9"])
def test_model_kernels_on_meta_launch_nothing(name, dtype):
    fn, args, kwargs = _model_kernel(name, dtype)
    want = fn(*args, **kwargs)
    before = dict(kernels.LAUNCHES)
    got = fn(*_to_meta(args), **kwargs)
    want, got = ((want,), (got,)) if isinstance(want, torch.Tensor) else (
        want, got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    margs = _to_meta(args)
    with flops.CostCounter() as on_meta:
        fn(*margs, **kwargs)
    with flops.CostCounter() as on_cpu:
        fn(*args, **kwargs)
    assert on_meta.result() == on_cpu.result()
    assert kernels.LAUNCHES == before
    if name in ("K8", "K9"):
        out = fn(*_to_meta(args))
        assert isinstance(out, torch.Tensor) and out.shape == want[0].shape


def _mst_kernel(name):
    g = np.random.default_rng(0)
    seg = torch.from_numpy(np.sort(g.integers(0, 9, 30)).astype(np.int32))
    key = torch.from_numpy(g.integers(-2 ** 40, 2 ** 40, 30))
    oth = torch.from_numpy(g.integers(0, 9, 30).astype(np.int32))
    if name == "K1":
        return k14.segmented_min2_scan, (seg, key)
    if name == "K2":
        return k23.masked_minplus_scan, (seg, oth, key)
    if name == "K3":
        return k23.pointer_jump, (torch.zeros(9, dtype=torch.int32), oth)
    if name == "K4":
        return k14.segmented_min_scan, (seg, oth)
    if name == "K5":
        tab = hash_ops.build_table(g.integers(0, 9, 20), g.integers(0, 9, 20),
                                   np.arange(20), 81)
        return k5.hash_lookup, tuple(torch.from_numpy(a) for a in tab) + (
            oth, oth)
    graph = generators.rmat(5, seed=1)
    params = GHSParams()
    topo, shards = ghs_state.host_shards(graph, 1, params)
    state = ghs_state.upload(shards[0], "meta")
    return (lambda st, sc: ghs_superstep.interval(
        st, sc, 1, step_ref.config(topo, params)),
        (state, torch.zeros(3, dtype=torch.int32)))


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "K5", "GHS"])
def test_mst_kernels_raise_on_meta(name):
    fn, args = _mst_kernel(name)
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        fn(*_to_meta(args))


# --------------------------------------------------------------------------
# decode inputs and the placements of the state
# --------------------------------------------------------------------------

def _named_leaves(tree, prefix=""):
    """{dotted name: leaf} of a port decode state (dataclasses, tuples,
    tensors and the caches' host int ``index``)."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_named_leaves(getattr(tree, f.name),
                                     f"{prefix}{f.name}."))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_named_leaves(sub, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _jax_named_leaves(ref, tree) -> dict:
    out = {}
    for path, leaf in ref.jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for k in path:
            parts.append(str(getattr(k, "name", getattr(
                k, "key", getattr(k, "idx", k)))))
        out[".".join(parts)] = leaf
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_decode_input_specs_equal_reference(ref, arch):
    shape = SHAPES["decode_32k"]
    state, tokens = serve_step.decode_input_specs(
        get_config(arch), shape.global_batch, shape.seq_len)
    rstate, rtokens = ref.serve.decode_input_specs(
        ref.configs.get_config(arch), shape.global_batch, shape.seq_len)
    got, want = _named_leaves(state), _jax_named_leaves(ref, rstate)
    assert set(got) == set(want)
    for name, leaf in got.items():
        w = want[name]
        if name.endswith("index"):
            assert leaf == shape.seq_len - 1 and w.shape == ()
            assert str(w.dtype) == "int32"
            continue
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(w.shape), name
        assert str(leaf.dtype) == f"torch.{w.dtype}", name
    assert (tokens.device.type, tuple(tokens.shape), tokens.dtype) == (
        "meta", tuple(rtokens.shape), torch.int32)
    assert str(rtokens.dtype) == "int32"


def _spec(entry_list) -> tuple:
    """A spec with one-axis tuples as that axis (``PartitionSpec``'s
    form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entry_list)


@pytest.mark.parametrize("mesh_name", list(MESH_AXES))
@pytest.mark.parametrize("arch", list_archs())
def test_decode_state_specs_equal_reference(ref, monkeypatch, arch,
                                            mesh_name):
    """The port's placements of the decode state against the JAX
    package's ``decode_state_shardings`` (its ``NamedSharding`` replaced
    by the bare spec, its mesh a stand-in with ``.shape``; the port's a
    DeviceMesh over a fake group)."""
    axes = MESH_AXES[mesh_name]
    jmesh = types.SimpleNamespace(shape=dict(axes), axis_names=tuple(axes))
    rrules = ref.mesh.make_rules(jmesh)
    shape = SHAPES["decode_32k"]
    cfg, rcfg = get_config(arch), ref.configs.get_config(arch)
    state, _ = serve_step.decode_input_specs(cfg, shape.global_batch,
                                             shape.seq_len)
    rstate, _ = ref.serve.decode_input_specs(rcfg, shape.global_batch,
                                             shape.seq_len)
    monkeypatch.setattr(ref.dryrun, "NamedSharding", lambda m, spec: spec)
    want = _jax_named_leaves(ref, ref.dryrun.decode_state_shardings(
        rcfg, rstate, jmesh, rrules, shape.global_batch, shape.seq_len))
    n_ranks, multi = dryrun.MESHES[mesh_name]
    with port_mesh.fake_world(n_ranks):
        mesh = port_mesh.make_production_mesh(multi_pod=multi)
        got = dryrun.decode_state_specs(cfg, state, mesh,
                                        port_mesh.make_rules(mesh),
                                        shape.global_batch)
    alias = {"cross_k": "1.0", "cross_v": "1.1"}
    for name, (tensor, spec) in got.items():
        key = alias.get(name, name)
        if cfg.family == "encdec" and name in ("k", "v"):
            key = f"0.{name}"
        jspec = tuple(want[key])
        assert _spec(spec) == jspec + (None,) * (tensor.ndim - len(jspec)), \
            name
    placed = {alias.get(n, n) for n in got}
    if cfg.family == "encdec":
        placed = {f"0.{n}" if n in ("k", "v") else n for n in placed}
    assert placed == {n for n in want if not n.endswith("index")}


@pytest.mark.parametrize("mesh_name", list(MESH_AXES))
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b",
                                  "rwkv6-3b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_placed_parameter_bytes_equal_the_rules(ref, arch, mesh_name):
    """Rank 0's float32 master bytes from the DTensor placements equal the
    JAX leaves (``jax.eval_shape`` of the JAX init) split by the JAX
    rules."""
    axes = MESH_AXES[mesh_name]
    mesh_like = types.SimpleNamespace(shape=dict(axes),
                                      axis_names=tuple(axes))
    rrules = ref.mesh.make_rules(mesh_like)
    rcfg = ref.configs.get_config(arch)
    tree = ref.jax.eval_shape(lambda r: ref.api.get_model(rcfg).init(r, rcfg),
                              ref.jax.random.PRNGKey(0))
    want = 0
    for path, leaf in ref.specs.tree_paths(tree).items():
        spec = tuple(ref.specs.param_spec(path, leaf.shape, rrules,
                                          mesh_like))
        n = 1
        for i, dim in enumerate(leaf.shape):
            e = spec[i] if i < len(spec) else None
            n *= dim // ref.specs._axis_size(mesh_like, e)
        want += 4 * n
    n_ranks, multi = dryrun.MESHES[mesh_name]
    with port_mesh.fake_world(n_ranks):
        mesh = port_mesh.make_production_mesh(multi_pod=multi)
        model = dryrun.meta_model(get_config(arch), torch.float32)
        got = dryrun.placed_bytes(dryrun.placed_params(
            model, mesh, port_mesh.make_rules(mesh)), mesh)
    assert got == want
    n_params = sum(p.numel() for p in model.parameters())
    assert got < 4 * n_params


# --------------------------------------------------------------------------
# cells and the CLI
# --------------------------------------------------------------------------

def _jax_record_keys(ref, monkeypatch, tmp_path) -> dict:
    """The JAX dry run's record of one cheap cell: a decode step of
    Qwen1.5-0.5B's smoke config on a one-device mesh."""
    from repro.configs.shapes import ShapeConfig
    monkeypatch.setattr(ref.dryrun, "get_config",
                        lambda arch: ref.configs.get_config(arch, True))
    monkeypatch.setitem(ref.dryrun.SHAPES, "tiny",
                        ShapeConfig("tiny", "decode", 64, 2))
    mesh = ref.mesh.make_host_mesh(1, 1)
    rec = ref.dryrun.run_cell("qwen1.5-0.5b", "tiny", mesh,
                              ref.mesh.make_rules(mesh), "host1x1",
                              str(tmp_path / "jax"))
    assert rec["status"] == "ok", rec
    return rec


def test_run_cell_writes_the_reference_record(ref, monkeypatch, tmp_path):
    want = _jax_record_keys(ref, monkeypatch, tmp_path)
    with port_mesh.fake_world(256):
        mesh = port_mesh.make_production_mesh()
        rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", mesh,
                              port_mesh.make_rules(mesh), "pod16x16",
                              str(tmp_path))
    assert not dist.is_initialized()
    path = tmp_path / "qwen1.5-0.5b__decode_32k__pod16x16.json"
    assert json.loads(path.read_text()) == rec
    assert rec["status"] == "ok", rec
    assert set(want) <= set(rec)
    assert set(want["memory"]) <= set(rec["memory"])
    for key in ("compile_s", "collectives", "flops_per_device",
                "bytes_per_device"):
        assert rec[key] is None
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["peak_bytes"] is None
    cfg = get_config("qwen1.5-0.5b")
    assert rec["n_devices"] == 256 and rec["tokens"] == 128
    assert rec["model_flops"] == 2 * cfg.active_param_count() * 128
    assert rec["kernels"]["decode_attention"]["calls"] == cfg.n_layers
    assert 0 < rec["counted_matmul_flops"] < rec["jaxpr_flops_global"]
    mem = rec["memory"]
    assert mem["argument_bytes"] > mem["param_bytes"] + mem["state_bytes"]


def test_long_500k_skips_a_dense_arch(ref, tmp_path):
    with port_mesh.fake_world(512):
        mesh = port_mesh.make_production_mesh(multi_pod=True)
        rec = dryrun.run_cell("qwen2.5-32b", "long_500k", mesh,
                              port_mesh.make_rules(mesh), "multipod2x16x16",
                              str(tmp_path))
    want = ref.dryrun.applicable(ref.configs.get_config("qwen2.5-32b"),
                                 ref.dryrun.SHAPES["long_500k"])
    assert rec == dict(arch="qwen2.5-32b", shape="long_500k",
                       mesh="multipod2x16x16", status="skip",
                       reason=want[1])
    assert want[0] is False
    assert (tmp_path / "qwen2.5-32b__long_500k__multipod2x16x16.json"
            ).exists()


def test_cli_exits_1_on_a_failed_cell(monkeypatch, tmp_path, capsys):
    args = ["--arch", "qwen1.5-0.5b", "--shape", "decode_32k,long_500k",
            "--mesh", "single", "--out", str(tmp_path)]
    assert dryrun.main(args) == 0

    def broken(*a):
        raise RuntimeError("broken cell")

    monkeypatch.setitem(dryrun.COUNT_BY_KIND, "decode", broken)
    assert dryrun.main(args) == 1
    rec = json.loads((tmp_path / "qwen1.5-0.5b__decode_32k__pod16x16.json"
                      ).read_text())
    assert rec["status"] == "fail" and "broken cell" in rec["reason"]
    assert "failures=1" in capsys.readouterr().out
    assert not dist.is_initialized()

"""The port's training substrate held against the JAX package's on the
CPU: the bf16 gradient compression (bit for bit), checkpoints (layout,
atomic save, pruning, shape checks, and a resumed run equal to an
uninterrupted one, bit for bit) and the token datasets (byte for byte).
"""
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.data.tokens import DataConfig, make_dataset
from repro_torch.models import api
from repro_torch.sharding.collectives import compress_tree
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                          make_train_step)


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's collectives and data pipeline, imported for this
    module only (the ``jax.experimental.enable_x64`` name is installed for
    the import and removed again with the ``repro`` modules on
    teardown)."""
    import jax
    import jax.experimental
    import jax.numpy as jnp
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro.data import tokens as rtokens
        from repro.sharding import collectives as rcoll
        yield types.SimpleNamespace(jax=jax, jnp=jnp, coll=rcoll,
                                    tokens=rtokens)
    finally:
        if shimmed:
            del jax.experimental.enable_x64
        for name in _repro_modules():
            del sys.modules[name]
        sys.modules.update(saved)


# --- bf16 gradient compression -----------------------------------------------

def _grad_tree(seed):
    """float32 gradients with values at and beside bf16's halfway points
    (ties go to even), zeros of both signs, and a spread of magnitudes.
    Exponents stay at 2⁻⁹⁵ and above, so that every residual is a normal
    number: XLA on the CPU flushes subnormals to zero and PyTorch keeps
    them, a difference of the platforms and not of the function."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(4096).astype(np.float32)
    sign = rng.integers(0, 2, 1024).astype(np.uint32) << 31
    expo = rng.integers(32, 250, 1024).astype(np.uint32) << 23
    high = rng.integers(0, 1 << 7, 1024).astype(np.uint32) << 16
    low = np.where(np.arange(1024) % 2 == 0, 0x8000,       # exact halfway
                   rng.integers(0x7FF0, 0x8010, 1024)).astype(np.uint32)
    b = np.concatenate([(sign | expo | high | low).view(np.float32),
                        [0.0, -0.0, 1e-30, -3e38]]).astype(np.float32)
    return dict(w=w.reshape(64, 64), b=b)


def test_compress_tree_bit_for_bit(ref):
    """Two rounds (the second with the first's residual): each compressed
    gradient and residual equals the JAX package's ``compress_tree``'s bit
    for bit."""
    res_t = res_j = None
    for seed in (0, 1):
        g = _grad_tree(seed)
        comp_t, res_t = compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, res_t)
        comp_j, res_j = ref.coll.compress_tree(
            {k: ref.jnp.asarray(v) for k, v in g.items()}, res_j)
        for k in g:
            assert comp_t[k].dtype == torch.bfloat16
            assert np.array_equal(comp_t[k].view(torch.int16).numpy(),
                                  np.asarray(comp_j[k]).view(np.int16)), k
            assert np.array_equal(res_t[k].numpy().view(np.int32),
                                  np.asarray(res_j[k]).view(np.int32)), k


def _subnormal_tree(seed):
    """float32 gradients and residuals whose inputs, sums or new residuals
    are subnormal: 2⁻¹²⁰·(1 + 2⁻⁹) (a residual of 2⁻¹²⁹), ±1e-39,
    ±2⁻¹²⁶·(1 + 2⁻¹⁰) (a residual of ∓2⁻¹³⁶), the smallest subnormals,
    normal pairs whose sum is subnormal, and signed zeros, each beside
    every residual of the list."""
    vals = np.array([2.0 ** -120 * (1 + 2.0 ** -9), 1e-39, -1e-39,
                     2.0 ** -126 * (1 + 2.0 ** -10),
                     -2.0 ** -126 * (1 + 2.0 ** -10), 2.0 ** -149,
                     -2.0 ** -149, 2.0 ** -125, -2.0 ** -126 * 1.125, 0.0,
                     -0.0, 1.0], np.float32)
    g, r = np.meshgrid(vals, vals)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.size)
    return (dict(w=g.reshape(-1)[perm].copy()),
            dict(w=r.reshape(-1)[perm].copy()))


def test_compress_tree_flushes_subnormals(ref):
    """Hazard H16: subnormal inputs, sums and residuals are zeros of their
    sign, as the JAX package's ``compress_tree`` gives them on the CPU, bit
    for bit over two rounds: the first with subnormal residuals given, the
    second with the first's residuals."""
    _, r = _subnormal_tree(0)
    res_t = {k: torch.from_numpy(v) for k, v in r.items()}
    res_j = {k: ref.jnp.asarray(v) for k, v in r.items()}
    for seed in (0, 1):
        g, _ = _subnormal_tree(seed)
        comp_t, res_t = compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, res_t)
        comp_j, res_j = ref.coll.compress_tree(
            {k: ref.jnp.asarray(v) for k, v in g.items()}, res_j)
        for k in g:
            assert np.array_equal(comp_t[k].view(torch.int16).numpy(),
                                  np.asarray(comp_j[k]).view(np.int16)), k
            assert np.array_equal(res_t[k].numpy().view(np.int32),
                                  np.asarray(res_j[k]).view(np.int32)), k


def test_grad_compression_error_feedback():
    """``tests/test_substrate.py``'s check on the port: compressed plus
    residual reconstructs the gradient."""
    g = dict(w=torch.from_numpy(np.random.default_rng(0)
                                .standard_normal(1000).astype(np.float32)))
    comp, res = compress_tree(g, None)
    assert comp["w"].dtype == torch.bfloat16
    rec = comp["w"].float() + res["w"]
    assert float((rec - g["w"]).abs().max()) < 1e-6


def test_train_step_with_compressed_grads_keeps_the_residual():
    cfg = get_config("qwen1.5-0.5b", True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    step = make_train_step(cfg, TrainHParams(
        remat="none", adamw=opt.AdamWConfig(compress_grads=True)))
    batch = api.synth_batch(0, cfg, 2, 16, device="cpu")
    state, m = step(state, batch)
    res = state["grad_residual"]
    assert sorted(res) == sorted(n for n, _ in
                                 state["params"].named_parameters())
    assert all(r.dtype == torch.float32 for r in res.values())
    assert any(float(r.abs().max()) > 0 for r in res.values())
    state, m = step(state, batch)
    assert torch.isfinite(m["loss"])


# --- checkpoints -------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = dict(a=np.arange(12, dtype=np.float32).reshape(3, 4),
                b=dict(c=np.ones(5, np.int32), d=np.float32(2.5)),
                t=torch.arange(6, dtype=torch.float32).reshape(2, 3),
                h=torch.full((3,), 1.5, dtype=torch.bfloat16))
    ckpt_lib.save(str(tmp_path), 7, tree)
    template = dict(a=np.zeros((3, 4), np.float32),
                    b=dict(c=np.zeros(5, np.int32), d=np.float32(0)),
                    t=torch.zeros(2, 3), h=torch.zeros(3, dtype=torch.bfloat16))
    restored, meta = ckpt_lib.restore(str(tmp_path), template)
    assert meta["step"] == 7
    assert np.array_equal(restored["a"], tree["a"])
    assert np.array_equal(restored["b"]["c"], tree["b"]["c"])
    assert float(restored["b"]["d"]) == 2.5
    assert restored["t"] is template["t"] and torch.equal(restored["t"],
                                                           tree["t"])
    assert torch.equal(restored["h"], tree["h"])
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert [x["path"] for x in leaves] == ["a", "b.c", "b.d", "h", "t"]
    assert [x["file"] for x in leaves] == [f"leaf_{i:05d}.npy"
                                           for i in range(5)]


def test_checkpoint_atomic_and_prune(tmp_path):
    tree = dict(x=np.zeros(3, np.float32))
    for s in (1, 2, 3, 4, 5):
        ckpt_lib.save(str(tmp_path), s, tree, keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    assert ckpt_lib.latest_step(str(tmp_path)) == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt_lib.save(str(tmp_path), 1, dict(x=torch.zeros(3)))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_lib.restore(str(tmp_path), dict(x=torch.zeros(4)))
    with pytest.raises(KeyError, match="missing leaf y"):
        ckpt_lib.restore(str(tmp_path), dict(y=torch.zeros(3)))


def test_checkpoint_async_save(tmp_path):
    tree = dict(x=torch.arange(4.0))
    ckpt_lib.save_async(str(tmp_path), 3, tree).join(timeout=60)
    tree["x"].zero_()          # the snapshot was taken before this
    restored, _ = ckpt_lib.restore(str(tmp_path), dict(x=torch.zeros(4)))
    assert torch.equal(restored["x"], torch.arange(4.0))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-moe-a2.7b"])
def test_resume_equals_an_uninterrupted_run(tmp_path, arch):
    """Four steps in one run equal two steps, a save, a restore into a
    fresh state and two more, bit for bit: parameters, moments and step."""
    cfg = get_config(arch, True)
    hp = TrainHParams(remat="full",
                      adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=2))
    step = make_train_step(cfg, hp)
    data = make_dataset(DataConfig(vocab=cfg.vocab, seed=1), 2, 32,
                        device="cpu")

    def run(state, steps):
        for i in steps:
            state, _ = step(state, data.batch_at(i))
        return state

    straight = run(init_train_state(torch.Generator().manual_seed(0), cfg),
                   range(4))
    half = run(init_train_state(torch.Generator().manual_seed(0), cfg),
               range(2))
    ckpt_lib.save(str(tmp_path), 2, half)
    fresh = init_train_state(torch.Generator().manual_seed(5), cfg)
    fresh, meta = ckpt_lib.restore(str(tmp_path), fresh)
    assert meta["step"] == 2 and int(fresh["opt"]["step"]) == 2
    resumed = run(fresh, range(2, 4))
    want = ckpt_lib.tree_paths(straight)
    got = ckpt_lib.tree_paths(resumed)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("opt.m.layers.") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --- data --------------------------------------------------------------------

def test_synthetic_batches_equal_reference(ref):
    cfg = DataConfig(vocab=512, seed=3)
    mine = make_dataset(cfg, 4, 16, device="cpu")
    theirs = ref.tokens.make_dataset(ref.tokens.DataConfig(vocab=512, seed=3),
                                     4, 16)
    for step in (0, 5, 1234):
        got, want = mine.batch_at(step), theirs.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), want[k]), (step, k)
    assert torch.equal(mine.batch_at(5)["tokens"][:, 1:],
                       mine.batch_at(5)["labels"][:, :-1])


def test_token_file_batches_equal_reference(ref, tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(10000, dtype=np.uint16).tofile(path)
    mine = make_dataset(DataConfig(kind="file", path=str(path),
                                   vocab=65536), 2, 16, device="cpu")
    theirs = ref.tokens.make_dataset(ref.tokens.DataConfig(
        kind="file", path=str(path), vocab=65536), 2, 16)
    for step in (0, 1, 300, 10_000):
        got, want = mine.batch_at(step), theirs.batch_at(step)
        for k in ("tokens", "labels"):
            assert np.array_equal(got[k].numpy(), want[k]), (step, k)


def test_dataset_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        make_dataset(DataConfig(kind="tape"), 2, 4, device="cpu")

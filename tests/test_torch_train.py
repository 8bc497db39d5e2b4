"""The port's training path held against the JAX package's, in float32 on
the CPU: the loss and every gradient of the smoke models of the six dense
and MoE archs, RWKV6 and Jamba, remat, gradient accumulation, AdamW, the
attention's explicit backward, the launcher, and the families whose
training waits.

The JAX model differentiates ``ref.attention`` (hazard H5 in ROADMAP.md),
the port runs its attention Function: the plain forward on the CPU, then
``kernels/flash_attention/backward.py``; likewise the JAX RWKV6 and Jamba
differentiate their jnp scans, and the port runs the ``WKV6`` and
``SelectiveScan`` Functions (``tests/test_torch_train_recurrent.py``
checks those alone).  Tolerances: the loss within 1e-5
relative (float32 sums of 2,048 terms taken in another order); each
gradient leaf within 1e-4 × max(1, max |g|) of that leaf; remat variants
within 1e-6 of no remat (the same arithmetic, recomputed); AdamW's
parameters, moments, norm and rate within 1e-6 (one float32 update of
values of order 1, in another fusion).  Parameters cross between the
packages through ``convert.from_reference(train=True)`` and gradients
back through ``convert.to_reference``.  The tests marked ``gpu`` run the
attention Function and the train step on the card against the plain
version and the CPU.
"""
import dataclasses
import math
import re
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import backward as attn_bwd
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.launch import train as train_launch
from repro_torch.models import api, convert, transformer
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                          make_eval_step, make_train_step)

ARCHS = ["qwen1.5-0.5b", "qwen2.5-14b", "qwen2.5-32b", "phi3-mini-3.8b",
         "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "rwkv6-3b",
         "jamba-v0.1-52b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
ADAMW_TOL = 1e-6
BATCH, SEQ = 2, 1024          # two chunks of the chunked loss


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's models and train step, imported for this module
    only (the ``jax.experimental.enable_x64`` name is installed for the
    import and removed again with the ``repro`` modules on teardown).
    ``cache`` holds each JAX reference once for the module."""
    import jax
    import jax.experimental
    import jax.numpy as jnp
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro import configs
        from repro.models import api as rapi
        from repro.train import optimizer as ropt
        from repro.train import train_step as rtrain
        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                    api=rapi, opt=ropt, train=rtrain,
                                    cache={})
    finally:
        if shimmed:
            del jax.experimental.enable_x64
        for name in _repro_modules():
            del sys.modules[name]
        sys.modules.update(saved)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never while the module imports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _np_tree(ref, tree):
    return ref.jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                      tree)


def _grads(ref, arch):
    """(JAX config, port config, JAX params, batch (numpy), loss, grads),
    the JAX side computed once for the module."""
    if arch not in ref.cache:
        rcfg = ref.configs.get_config(arch, True)
        model = ref.api.get_model(rcfg)
        params = model.init(ref.jax.random.PRNGKey(0), rcfg)
        batch = {k: np.asarray(v) for k, v in
                 ref.api.synth_batch(0, rcfg, BATCH, SEQ).items()}
        loss, grads = ref.jax.jit(ref.jax.value_and_grad(
            lambda p, b: model.loss_fn(p, b, rcfg)))(params, batch)
        ref.cache[arch] = (rcfg, get_config(arch, True),
                           _np_tree(ref, params), batch, float(loss),
                           _np_tree(ref, grads))
    return ref.cache[arch]


def _tensors(batch, device="cpu"):
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def _port_grads(model, cfg, batch, remat="none"):
    names, leaves = zip(*model.named_parameters())
    loss = api.get_model(cfg).loss_fn(model, batch, cfg, remat=remat)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))


def _leaf_pairs(got, want, path=()):
    """(path, got leaf, want leaf) over two nested dicts of one shape."""
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            yield from _leaf_pairs(got[k], want[k], path + (k,))
        else:
            yield path + (k,), got[k], want[k]


def _assert_tree_close(got, want, tol, scaled=True):
    """Each leaf within ``tol`` (× max(1, max |want|) of that leaf when
    ``scaled``); returns the largest such ratio."""
    worst = 0.0
    for path, g, w in _leaf_pairs(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        lim = tol * (max(1.0, float(np.abs(w).max())) if scaled else 1.0)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= lim, (path, err, lim)
        worst = max(worst, err / lim)
    return worst


# --- the loss and its gradients ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(ref, arch):
    """The chunked loss (with the MoE aux loss) and every gradient leaf of
    the smoke model equal ``jax.value_and_grad`` of the JAX ``loss_fn``."""
    _, cfg, params, batch, want_loss, want_grads = _grads(ref, arch)
    model = convert.from_reference(params, cfg, device="cpu", train=True)
    loss, grads = _port_grads(model, cfg, _tensors(batch))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_tree_close(convert.to_reference(grads, cfg), want_grads,
                       GRAD_TOL)


@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-moe-a2.7b"])
def test_remat_matches_no_remat(ref, monkeypatch, arch, remat):
    """Every checkpoint policy gives no remat's loss and gradients; the
    recomputed forward reruns the attention (twice its calls)."""
    _, cfg, params, batch, _, _ = _grads(ref, arch)
    model = convert.from_reference(params, cfg, device="cpu", train=True)
    calls = []
    orig = attn_ops.flash_attention
    monkeypatch.setattr(attn_ops, "flash_attention", lambda *a, **kw: (
        calls.append(1), orig(*a, **kw))[1])
    loss0, g0 = _port_grads(model, cfg, _tensors(batch))
    n0 = len(calls)
    loss1, g1 = _port_grads(model, cfg, _tensors(batch), remat=remat)
    assert n0 == cfg.n_layers and len(calls) - n0 == 2 * cfg.n_layers
    assert abs(float(loss1) - float(loss0)) <= REMAT_TOL
    for n in g0:
        assert float((g1[n] - g0[n]).abs().max()) <= REMAT_TOL, n


# family -> {the plain call a kernel's wrapper takes on the CPU: calls a
# forward}, in the smoke model of one superblock or two layers
RECURRENT = {
    "rwkv6-3b": {(wkv_ops, "_wkv6"): 2},
    "jamba-v0.1-52b": {(scan_ops, "_selective_scan"): 7,
                       (attn_ops, "flash_attention"): 1},
}


@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_recurrent_remat_matches_no_remat(ref, monkeypatch, arch):
    """RWKV6 under a checkpoint a layer and Jamba under one a superblock
    (``full``) give no remat's loss and gradients; the recomputed forward
    reruns K9 (K8 and K6), so each runs twice its calls."""
    _, cfg, params, batch, _, _ = _grads(ref, arch)
    model = convert.from_reference(params, cfg, device="cpu", train=True)
    calls = {}
    for (mod, name) in RECURRENT[arch]:
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _o(*a, **kw))[1])
    loss0, g0 = _port_grads(model, cfg, _tensors(batch))
    n0 = dict(calls)
    loss1, g1 = _port_grads(model, cfg, _tensors(batch), remat="full")
    for (_, name), per in RECURRENT[arch].items():
        assert n0[name] == per and calls[name] - n0[name] == 2 * per, calls
    assert abs(float(loss1) - float(loss0)) <= REMAT_TOL
    for n in g0:
        assert float((g1[n] - g0[n]).abs().max()) <= REMAT_TOL, n


def test_unknown_remat_raises():
    cfg = get_config("qwen1.5-0.5b", True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    batch = api.synth_batch(0, cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        transformer.loss_fn(state["params"], batch, cfg, remat="some")


@pytest.fixture(scope="module")
def accum_ref(ref):
    """JAX's train step at grad_accum 1 and 2 on one batch: (params,
    batch, {accum: (loss, grad_norm)})."""
    rcfg = ref.configs.get_config("qwen1.5-0.5b", True)
    batch = {k: np.asarray(v) for k, v in
             ref.api.synth_batch(4, rcfg, 4, 32).items()}
    s0 = ref.train.init_train_state(ref.jax.random.PRNGKey(0), rcfg)
    out = {}
    for a in (1, 2):
        step = ref.train.make_train_step(
            rcfg, ref.train.TrainHParams(remat="none", grad_accum=a))
        _, m = step(ref.jax.tree.map(ref.jnp.copy, s0), batch)
        out[a] = (float(m["loss"]), float(m["grad_norm"]))
    return _np_tree(ref, s0["params"]), batch, out


@pytest.mark.parametrize("accum", [1, 2])
def test_grad_accum(ref, accum_ref, accum):
    """grad_accum 2 against 1 with ``tests/test_models.py``'s tolerances,
    and each against JAX's train step at the same accumulation."""
    params, batch, want = accum_ref
    cfg = get_config("qwen1.5-0.5b", True)
    got = {}
    for a in (1, accum):
        model = convert.from_reference(params, cfg, device="cpu", train=True)
        state = dict(params=model,
                     opt=opt.init(dict(model.named_parameters())))
        step = make_train_step(cfg, TrainHParams(remat="none",
                                                 grad_accum=a))
        _, m = step(state, _tensors(batch))
        got[a] = (float(m["loss"]), float(m["grad_norm"]))
    assert abs(got[1][0] - got[accum][0]) < 1e-4
    assert abs(got[1][1] - got[accum][1]) < 2e-3
    loss, gnorm = got[accum]
    assert abs(loss - want[accum][0]) <= LOSS_RTOL * abs(want[accum][0])
    assert abs(gnorm - want[accum][1]) <= LOSS_RTOL * abs(want[accum][1])


def test_grad_accum_needs_a_split_batch():
    cfg = get_config("qwen1.5-0.5b", True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    step = make_train_step(cfg, TrainHParams(remat="none", grad_accum=2))
    with pytest.raises(ValueError, match="microbatches"):
        step(state, api.synth_batch(0, cfg, 3, 8, device="cpu"))


# --- AdamW -------------------------------------------------------------------

def test_adamw_matches_reference_over_three_steps(ref):
    """Given JAX's gradients at JAX's parameters of each step, the port's
    update gives ``opt.update``'s parameters, moments, norm and rate
    (warm-up of 2 steps, clipping active)."""
    rcfg, cfg, params, batch, _, _ = _grads(ref, "qwen2-moe-a2.7b")
    model_ref = ref.api.get_model(rcfg)
    grad_fn = ref.jax.jit(ref.jax.grad(
        lambda p, b: model_ref.loss_fn(p, b, rcfg)))
    acfg = dict(lr=1e-3, warmup_steps=2, clip_norm=0.5)
    rparams = ref.jax.tree.map(ref.jnp.asarray, params)
    rstate = ref.opt.init(rparams)
    model = convert.from_reference(params, cfg, device="cpu", train=True)
    port = dict(model.named_parameters())
    state = opt.init(port)
    for _ in range(3):
        g = grad_fn(rparams, batch)
        grads = dict(convert.from_reference(
            _np_tree(ref, g), cfg, device="cpu", train=True)
            .named_parameters())
        rparams, rstate, rm = ref.opt.update(g, rstate, rparams,
                                             ref.opt.AdamWConfig(**acfg))
        _, state, m = opt.update(grads, state, port, opt.AdamWConfig(**acfg))
        assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= \
            ADAMW_TOL * float(rm["grad_norm"])
        assert abs(float(m["lr"]) - float(rm["lr"])) <= ADAMW_TOL * acfg["lr"]
        assert int(state["step"]) == int(rstate["step"])
        _assert_tree_close(convert.to_reference(port, cfg),
                           _np_tree(ref, rparams), ADAMW_TOL)
        for k in ("m", "v"):
            _assert_tree_close(convert.to_reference(state[k], cfg),
                               _np_tree(ref, rstate[k]), ADAMW_TOL)


def test_global_norm_of_large_gradients_matches_reference(ref):
    """Hazard H17: the global norm of 2²⁴ + 2²⁰ float32 values of spread
    magnitudes equals the JAX package's ``global_norm`` within 1e-6
    relative (a float32 running sum on the CPU was 1.5e-4 off here)."""
    rng = np.random.default_rng(6)
    grads = dict(big=rng.standard_normal(1 << 24).astype(np.float32),
                 small=(rng.standard_normal(1 << 20) * 30).astype(np.float32))
    grads["big"][:4096] *= 100
    want = float(ref.opt.global_norm({k: ref.jnp.asarray(v)
                                      for k, v in grads.items()}))
    got = opt.global_norm([torch.from_numpy(v) for v in grads.values()])
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want


def test_adamw_decreases_loss():
    """``tests/test_substrate.py``'s least-squares check on the port."""
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    y = x @ w_true
    params = dict(w=torch.zeros(8, requires_grad=True))
    state = opt.init(params)
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)

    def loss_fn():
        return ((x @ params["w"] - y) ** 2).mean()

    l0 = float(loss_fn())
    for _ in range(50):
        (g,) = torch.autograd.grad(loss_fn(), (params["w"],))
        opt.update(dict(w=g), state, params, cfg)
    assert float(loss_fn()) < l0 * 0.1


# --- the attention's backward ------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_attention_backward_gradcheck(causal):
    """``torch.autograd.gradcheck`` of the attention Function in float64
    (B 1, Hq 4 over Hkv 2, S 5, D 8): on the CPU its forward is the plain
    version, so this checks the explicit backward."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 4, 5, 8, dtype=torch.float64, generator=g)
    k = torch.randn(1, 2, 5, 8, dtype=torch.float64, generator=g)
    v = torch.randn(1, 2, 5, 8, dtype=torch.float64, generator=g)
    args = tuple(t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: attn_ops.Attention.apply(a, b, c, causal, None),
        args)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_backward_matches_autograd_of_plain(causal):
    """float32, GQA (6 over 2 heads), S 37: the explicit backward against
    autograd through the plain version."""
    g = torch.Generator().manual_seed(4)
    shapes = ((2, 6, 37, 16), (2, 2, 37, 16), (2, 2, 37, 16))
    q, k, v = (torch.randn(s, generator=g).requires_grad_() for s in shapes)
    do = torch.randn(2, 6, 37, 16, generator=g)
    o = attn_ref.attention(q, k, v, causal=causal, scale=0.3)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = attn_bwd.attention_backward(q.detach(), k.detach(), v.detach(),
                                      o.detach(), do, causal=causal,
                                      scale=0.3)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


def test_attention_dispatch():
    """With a gradient to carry, ``attention`` goes through the Function,
    also past 1,024 positions (its backward then in query blocks); without
    one, the kernel's call alone."""
    q = torch.randn(1, 2, 8, 8, requires_grad=True)
    k = torch.randn(1, 2, 8, 8)
    o = attn_ops.attention(q, k, k)
    assert type(o.grad_fn).__name__ == "AttentionBackward"
    with torch.no_grad():
        assert attn_ops.attention(q, k, k).grad_fn is None
    assert attn_ops.attention(q.detach(), k, k).grad_fn is None
    long = torch.randn(1, 1, 1025, 8, requires_grad=True)
    o = attn_ops.attention(long, long, long)
    assert type(o.grad_fn).__name__ == "AttentionBackward"
    (g,) = torch.autograd.grad(o.sum(), (long,))
    assert g.shape == long.shape and bool(torch.isfinite(g).all())


# --- models, API and the launcher --------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-moe-a2.7b",
                                  "rwkv6-3b", "jamba-v0.1-52b"])
def test_to_reference_inverts_from_reference(arch):
    """``from_reference`` of ``to_reference`` of a model's state is that
    state, tensor for tensor (transposes, layer stacks and Jamba's
    substacks undone and redone); ``from_reference`` itself is held
    against the JAX package's layout in the serving tests."""
    cfg = get_config(arch, True)
    model = api.get_model(cfg).init(torch.Generator().manual_seed(1), cfg)
    tree = convert.to_reference(model.state_dict(), cfg)
    back = convert.from_reference(tree, cfg, device="cpu").state_dict()
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name


def test_training_model_layout():
    """A training model holds float32 masters that all require grad; a
    served one keeps the compute type and no grad."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", True),
                              compute_dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    train = transformer.init(g, cfg, master=torch.float32)
    serve = transformer.init(torch.Generator().manual_seed(0), cfg)
    for (n, p), (n2, s) in zip(train.named_parameters(),
                               serve.named_parameters()):
        assert n == n2 and p.dtype == torch.float32 and p.requires_grad
        assert not s.requires_grad
        assert torch.equal(p.to(s.dtype), s), n
    assert serve.layers[0].attn.wq.dtype == torch.bfloat16


def test_train_input_specs_match_reference(ref):
    for arch in ("qwen1.5-0.5b", "seamless-m4t-large-v2", "internvl2-2b"):
        want = ref.api.train_input_specs(ref.configs.get_config(arch), 8, 64)
        got = api.train_input_specs(get_config(arch), 8, 64)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert str(t.dtype).split(".")[1] == str(want[k].dtype), k


@pytest.mark.parametrize("arch,slice_", [
    ("seamless-m4t-large-v2", "item 14, slice 4a"),
    ("internvl2-2b", "item 14, slice 4a")])
def test_families_that_wait_raise(arch, slice_):
    """No family waits since the encoder–decoder and VLM families came
    (``slice_``): ``WAITING`` is empty, each trains a step of finite loss
    with its frontend embeddings, and a family the API does not know
    raises."""
    assert api.WAITING == {}, slice_
    cfg = get_config(arch, True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    batch = api.synth_batch(0, cfg, 2, 8, device="cpu")
    _, m = make_train_step(cfg, TrainHParams(remat="none"))(state, batch)
    assert math.isfinite(float(m["loss"]))
    with pytest.raises(ValueError):
        api.get_model(dataclasses.replace(cfg, family="nope"))


def test_eval_step_runs_without_grad():
    cfg = get_config("qwen3-moe-30b-a3b", True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    batch = api.synth_batch(0, cfg, 2, 16, device="cpu")
    loss = make_eval_step(cfg)(state["params"], batch)
    assert loss.grad_fn is None and torch.isfinite(loss)
    want = transformer.loss_fn(state["params"], batch, cfg)
    assert float(loss) == float(want)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """Three steps with checkpoints, then ``--resume`` to five; the resumed
    run ends where five steps in one run end, bit for bit."""
    base = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--log-every", "1"]
    train_launch.main(base + ["--steps", "3", "--ckpt-dir",
                              str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert len(re.findall(r"^step +\d+ loss", out, re.M)) == 3
    resumed = train_launch.main(base + ["--steps", "5", "--resume",
                                        "--ckpt-dir", str(tmp_path / "a")])
    assert "resumed from step 3" in capsys.readouterr().out
    straight = train_launch.main(base + ["--steps", "5"])
    for (n, a), (_, b) in zip(resumed["params"].named_parameters(),
                              straight["params"].named_parameters()):
        assert torch.equal(a, b), n
    assert int(resumed["opt"]["step"]) == 5


def test_launcher_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="item 13b"):
        train_launch.main(["--smoke", "--device", "cpu", "--mesh", "2x1"])


# --- on the card -------------------------------------------------------------

def _attention_inputs(device, dtype, shape_q, hkv, seed):
    g = torch.Generator().manual_seed(seed)
    b, hq, s, d = shape_q
    q = torch.randn(b, hq, s, d, generator=g)
    k = torch.randn(b, hkv, s, d, generator=g)
    v = torch.randn(b, hkv, s, d, generator=g)
    do = torch.randn(b, hq, s, d, generator=g)
    return [t.to(device, dtype) for t in (q, k, v, do)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_attention_function_matches_plain_autograd(cuda, dtype, causal):
    """K6 forward and the explicit backward against autograd through the
    plain version on the card: float32 within 1e-4 × max |g|, bf16 within
    two bf16 ulps (2⁻⁶) of max |g|; K6 launched once."""
    q, k, v, do = _attention_inputs(cuda, dtype, (2, 8, 200, 64), 2, 5)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kernels.reset_launches()
    got = torch.autograd.grad(attn_ops.attention(q, k, v, causal=causal),
                              (q, k, v), do)
    assert kernels.LAUNCHES["flash_attention"] == 1
    want = torch.autograd.grad(attn_ref.attention(q, k, v, causal=causal),
                               (q, k, v), do)
    rel = 1e-4 if dtype == torch.float32 else 2 ** -6
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert float((a.float() - b.float()).abs().max()) <= rel * float(
            b.float().abs().max())


def _train_state(cfg, device, seed=0):
    cpu = init_train_state(torch.Generator().manual_seed(seed), cfg)
    if device == "cpu":
        return cpu
    model = transformer.Transformer(cfg, device=device, master=torch.float32)
    model.load_state_dict(cpu["params"].state_dict())
    return dict(params=model, opt=opt.init(dict(model.named_parameters())))


@pytest.mark.gpu
def test_gpu_train_step_matches_cpu(cuda):
    """Float32, the same weights: the loss within 1e-5 relative and every
    gradient within 1e-4 × max(1, max |g|) of the CPU's; K6 once a
    layer."""
    cfg = get_config("qwen1.5-0.5b", True)
    batch = api.synth_batch(0, cfg, 2, 128, device="cpu")
    cpu, card = _train_state(cfg, "cpu"), _train_state(cfg, cuda)
    names = [n for n, _ in cpu["params"].named_parameters()]
    want_l, want = _port_grads(cpu["params"], cfg, batch)
    kernels.reset_launches()
    got_l, got = _port_grads(card["params"], cfg, _tensors(batch, cuda))
    assert kernels.LAUNCHES["flash_attention"] == cfg.n_layers
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    for n in names:
        tol = 1e-4 * max(1.0, float(want[n].abs().max()))
        assert float((got[n].cpu() - want[n]).abs().max()) <= tol, n


@pytest.mark.gpu
def test_gpu_train_steps_read_nothing_on_the_host(cuda):
    """bf16 compute, float32 masters: steps after the first run under sync
    debug mode "error" and the loss falls on a repeated batch."""
    for arch in ("qwen1.5-0.5b", "qwen3-moe-30b-a3b"):
        cfg = dataclasses.replace(get_config(arch, True),
                                  compute_dtype="bfloat16")
        state = _train_state(cfg, cuda)
        step = make_train_step(cfg, TrainHParams(
            remat="full", adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=1)))
        batch = api.synth_batch(0, cfg, 4, 64, device=cuda)
        losses = []
        state, m = step(state, batch)
        losses.append(m["loss"])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                state, m = step(state, batch)
                losses.append(m["loss"])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses = [float(x) for x in losses]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

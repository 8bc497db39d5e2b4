"""Training of the recurrent families, RWKV6 and Jamba: the autograd
Functions ``WKV6`` and ``SelectiveScan`` (K9 and K8 forward, explicit
backwards in tensor operations), the training layout of the models, their
parameters loaded from the JAX package's as masters and given back, and
the launcher.

The JAX package trains RWKV6 and Jamba by differentiating its jnp scans
(``ref.wkv6``, ``ref.selective_scan``); the port's backwards
(``kernels/rwkv6/backward.py``, ``kernels/mamba_scan/backward.py``) are
held here against ``torch.autograd.gradcheck`` in float64 (on the CPU the
Functions' forwards are the plain versions) and against autograd through
the plain versions in float32, within 1e-5 × max(1, max |g|) (sums in
another order, over up to 300 steps).  ``tests/test_torch_train.py`` holds
the whole models' loss and gradients against ``jax.value_and_grad``.  The
tests marked ``gpu`` run the Functions and the train steps on the card.
"""
import dataclasses
import re
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import backward as scan_bwd
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.kernels.rwkv6 import backward as wkv_bwd
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.launch import train as train_launch
from repro_torch.models import api, convert
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainHParams, make_train_step

ARCHS = ["rwkv6-3b", "jamba-v0.1-52b"]
FUNC_TOL = 1e-5
BF16_REL = 2.0 ** -6       # two bf16 ulps of the largest |g|


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's models, imported for this module only (the
    ``jax.experimental.enable_x64`` name is installed for the import and
    removed again with the ``repro`` modules on teardown)."""
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
        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                    api=rapi)
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


# --- the Functions' inputs ---------------------------------------------------

def _wkv_inputs(bh, t, d, dtype, seed, device="cpu"):
    """r, k, v (BH, T, D) N(0, 1), the decay w in (0.4, 0.9), u (BH, D),
    and an output gradient."""
    g = torch.Generator().manual_seed(seed)
    r, k, v, do = (torch.randn(bh, t, d, generator=g) for _ in range(4))
    w = torch.rand(bh, t, d, generator=g) * 0.5 + 0.4
    u = torch.randn(bh, d, generator=g)
    return [z.to(device, dtype) for z in (r, k, v, w, u, do)]


def _scan_inputs(bsz, t, dim, n, dtype, seed, device="cpu"):
    """x, Δ in (1e-3, 0.5), b, c, a = -exp(log 1..N), d, and an output
    gradient; a and d float32 (float64 for float64 x)."""
    g = torch.Generator().manual_seed(seed)
    x, dy = (torch.randn(bsz, t, dim, generator=g) for _ in range(2))
    dt = torch.rand(bsz, t, dim, generator=g) * 0.5 + 1e-3
    b, c = (torch.randn(bsz, t, n, generator=g) for _ in range(2))
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(dim, n) \
        * (0.5 + torch.rand(dim, 1, generator=g))
    d = torch.randn(dim, generator=g)
    acc = torch.promote_types(dtype, torch.float32)
    return ([z.to(device, dtype) for z in (x, dt, b, c)]
            + [z.to(device, acc) for z in (a, d)] + [dy.to(device, dtype)])


def _close(got, want, rel):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        lim = rel * max(1.0, float(b.float().abs().max()))
        assert float((a.float() - b.float()).abs().max()) <= lim


# --- gradcheck ---------------------------------------------------------------

# (T, chunk): inside one chunk; three chunks, the last short; two whole ones
CHUNKINGS = [(5, 128), (10, 4), (8, 4)]


@pytest.mark.parametrize("t,chunk", CHUNKINGS)
def test_wkv6_gradcheck(monkeypatch, t, chunk):
    """``torch.autograd.gradcheck`` of the WKV6 Function in float64 (BH 2,
    D 4): on the CPU its forward is the plain version, so this checks the
    explicit backward, over one chunk and over several."""
    monkeypatch.setattr(wkv_bwd, "CHUNK", chunk)
    args = [z.requires_grad_() for z in
            _wkv_inputs(2, t, 4, torch.float64, seed=t)[:5]]
    assert torch.autograd.gradcheck(wkv_ops.WKV6.apply, args)


@pytest.mark.parametrize("t,chunk", CHUNKINGS)
def test_selective_scan_gradcheck(monkeypatch, t, chunk):
    """``gradcheck`` of the SelectiveScan Function in float64 (B 2, dim 3,
    N 4), a and d included."""
    monkeypatch.setattr(scan_bwd, "CHUNK", chunk)
    args = [z.requires_grad_() for z in
            _scan_inputs(2, t, 3, 4, torch.float64, seed=t)[:6]]
    assert torch.autograd.gradcheck(scan_ops.SelectiveScan.apply, args)


# --- the Functions against autograd through the plain versions ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_backward_matches_autograd_of_plain(dtype):
    """BH 6, T 300 (chunks of 128, 128 and 44), D 16: the explicit backward
    against autograd through ``ref.wkv6``, in the inputs' types (float32
    within 1e-5 × max(1, max |g|), bf16 within two bf16 ulps of it)."""
    *ins, do = _wkv_inputs(6, 300, 16, dtype, seed=1)
    ins = [z.requires_grad_() for z in ins]
    want = torch.autograd.grad(wkv_ref.wkv6(*ins), ins, do)
    got = wkv_bwd.wkv6_backward(*(z.detach() for z in ins), do)
    _close(got, want, FUNC_TOL if dtype == torch.float32 else BF16_REL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_backward_matches_autograd_of_plain(dtype):
    """B 2, T 300, dim 24, N 8: the explicit backward against autograd
    through ``ref.selective_scan``; a and d float32."""
    *ins, dy = _scan_inputs(2, 300, 24, 8, dtype, seed=2)
    ins = [z.requires_grad_() for z in ins]
    want = torch.autograd.grad(scan_ref.selective_scan(*ins), ins, dy)
    got = scan_bwd.selective_scan_backward(*(z.detach() for z in ins), dy)
    _close(got, want, FUNC_TOL if dtype == torch.float32 else BF16_REL)


def test_recurrent_dispatch():
    """With a gradient to carry, ``wkv6`` and ``selective_scan`` go through
    their Functions; without one, or with the final state asked for (the
    prefill), the kernels' call alone."""
    *w_ins, _ = _wkv_inputs(2, 6, 4, torch.float32, seed=3)
    *s_ins, _ = _scan_inputs(1, 6, 3, 4, torch.float32, seed=3)
    for call, ins, name in ((wkv_ops.wkv6, w_ins, "WKV6Backward"),
                            (scan_ops.selective_scan, s_ins,
                             "SelectiveScanBackward")):
        ins[0].requires_grad_()
        assert type(call(*ins).grad_fn).__name__ == name
        with torch.no_grad():
            assert call(*ins).grad_fn is None
        out, _ = call(*ins, return_state=True)
        assert type(out.grad_fn).__name__ != name
        assert call(ins[0].detach(), *ins[1:]).grad_fn is None


# --- the models --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_train_round_trip(ref, arch):
    """``from_reference(train=True)`` loads the JAX package's parameters as
    float32 masters that all require grad, and ``to_reference`` gives them
    back bit for bit (transposes, layer stacks and Jamba's substacks)."""
    rcfg = ref.configs.get_config(arch, True)
    params = _np_tree(ref, ref.api.get_model(rcfg).init(
        ref.jax.random.PRNGKey(1), rcfg))
    cfg = get_config(arch, True)
    model = convert.from_reference(params, cfg, device="cpu", train=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    back = convert.to_reference(dict(model.named_parameters()), cfg)
    flat = ref.jax.tree_util.tree_flatten_with_path
    got, want = flat(back)[0], flat(params)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w), path


@pytest.mark.parametrize("arch", ARCHS)
def test_training_model_layout(arch):
    """A training model holds float32 masters that all require grad, equal
    to the served model's weights cast to bf16; the served one keeps its
    matrices in bf16 (and H10's float32 leaves) with no grad."""
    cfg = dataclasses.replace(get_config(arch, True),
                              compute_dtype="bfloat16")
    init = api.get_model(cfg).init
    train = init(torch.Generator().manual_seed(0), cfg,
                 master=torch.float32)
    serve = init(torch.Generator().manual_seed(0), cfg)
    bf16 = 0
    for (n, p), (n2, s) in zip(train.named_parameters(),
                               serve.named_parameters()):
        assert n == n2 and p.dtype == torch.float32 and p.requires_grad
        assert not s.requires_grad
        assert torch.equal(p.to(s.dtype), s), n
        bf16 += s.dtype == torch.bfloat16
    assert bf16 > 0


def test_launcher_trains_and_resumes_rwkv6(tmp_path, capsys):
    """``--arch rwkv6-3b --smoke`` on the CPU: three steps with
    checkpoints, then ``--resume`` to five; the resumed run ends where
    five steps in one run end, bit for bit."""
    base = ["--arch", "rwkv6-3b", "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--log-every", "1", "--remat", "full"]
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


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_wkv6_function_matches_plain_autograd(cuda, dtype):
    """K9 forward and the explicit backward against autograd through the
    plain version on the card (BH 16, T 300, D 64): float32 within 1e-4 ×
    max |g|, bf16 within two bf16 ulps of it; K9 launched once."""
    *ins, do = _wkv_inputs(16, 300, 64, dtype, seed=4, device=cuda)
    ins = [z.requires_grad_() for z in ins]
    kernels.reset_launches()
    got = torch.autograd.grad(wkv_ops.wkv6(*ins), ins, do)
    assert kernels.LAUNCHES["wkv6"] == 1
    want = torch.autograd.grad(wkv_ref.wkv6(*ins), ins, do)
    _close(got, want, 1e-4 if dtype == torch.float32 else BF16_REL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_selective_scan_function_matches_plain_autograd(cuda, dtype):
    """K8 forward and the explicit backward against autograd through the
    plain version on the card (B 2, T 300, dim 512, N 16); K8 launched
    once."""
    *ins, dy = _scan_inputs(2, 300, 512, 16, dtype, seed=5, device=cuda)
    ins = [z.requires_grad_() for z in ins]
    kernels.reset_launches()
    got = torch.autograd.grad(scan_ops.selective_scan(*ins), ins, dy)
    assert kernels.LAUNCHES["selective_scan"] == 1
    want = torch.autograd.grad(scan_ref.selective_scan(*ins), ins, dy)
    _close(got, want, 1e-4 if dtype == torch.float32 else BF16_REL)


def _train_state(cfg, device, seed=0):
    """Float32 masters made on the CPU from ``seed``, on ``device``, and
    their AdamW state."""
    cpu = api.get_model(cfg).init(torch.Generator().manual_seed(seed), cfg,
                                  master=torch.float32)
    model = convert.MODELS[cfg.family][0](cfg, device=device,
                                          master=torch.float32)
    model.load_state_dict(cpu.state_dict())
    return dict(params=model, opt=opt.init(dict(model.named_parameters())))


# arch -> {kernel: launches a forward of the smoke model}
SMOKE_LAUNCHES = {"rwkv6-3b": {"wkv6": 2},
                  "jamba-v0.1-52b": {"selective_scan": 7,
                                     "flash_attention": 1}}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_train_step_matches_cpu(cuda, arch):
    """Float32, the same weights, batch 2, seq 128: the loss within 1e-5
    relative and every gradient within 1e-4 × max(1, max |g|) of the
    CPU's; K9 (K8 and K6) once a forward."""
    cfg = get_config(arch, True)
    batch = api.synth_batch(0, cfg, 2, 128, device="cpu")
    loss_fn = api.get_model(cfg).loss_fn

    def grads(model, b):
        names, leaves = zip(*model.named_parameters())
        loss = loss_fn(model, b, cfg)
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss,
                                                                  leaves)))

    want_l, want = grads(_train_state(cfg, "cpu")["params"], batch)
    kernels.reset_launches()
    got_l, got = grads(_train_state(cfg, cuda)["params"],
                       {k: v.to(cuda) for k, v in batch.items()})
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == \
        SMOKE_LAUNCHES[arch]
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    for n, w in want.items():
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((got[n].cpu() - w).abs().max()) <= tol, n


@pytest.mark.gpu
def test_gpu_rwkv6_train_steps_read_nothing_on_the_host(cuda):
    """bf16 compute, float32 masters, remat ``full``: steps 2-5 run under
    sync debug mode "error" and the loss falls on a repeated batch."""
    cfg = dataclasses.replace(get_config("rwkv6-3b", True),
                              compute_dtype="bfloat16")
    state = _train_state(cfg, cuda)
    step = make_train_step(cfg, TrainHParams(
        remat="full", adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=1)))
    batch = api.synth_batch(0, cfg, 4, 64, device=cuda)
    state, m = step(state, batch)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            state, m = step(state, batch)
            losses.append(m["loss"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

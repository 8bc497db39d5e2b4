"""The port's Jamba serving path and its selective-scan kernel (K8) held
against the JAX package: the plain scan against the Pallas kernel, run in
interpret mode, and against ``ref.py``; the decode step; the Mamba mixer;
the parameter conversion; and ``jamba-v0.1-52b-smoke`` in float32 on the
CPU, prefill logits, final states and teacher-forced decode logits.

The JAX model never runs its Pallas kernel (``mamba_apply`` calls the op
without ``use_pallas``, and the op takes the jnp scan for the state;
hazard H9 in ROADMAP.md), so the model is compared with the JAX model in
float32 on the CPU, where the port runs the kernel's plain version, and
K8 with that plain version on the card (tests marked ``gpu``, which skip
without one).

Tolerances.  The plain scan against the Pallas kernel and
``ref.selective_scan``: 1e-5 absolute in float32, on y and on the state.
The two sum over n in another order and take exp from another library, so
they differ by a few units in the last place; the inputs (x, b, c and d
N(0, 1), Δ log-uniform in [1e-3, 1], A = -(1..N)) keep y and the state
below 16, where a float32 ulp is at most 1.9e-6.  Models: logits and
states within 1e-4, the dense LM's tolerance (``test_torch_lm.py``).  On
the card, K8 against its plain version: 1e-4 absolute in float32 on y
(times max |y| where that is above 1) and on the state; in bf16 two bf16
ulps of y (2**-6 of it, plus 1e-5 near zero), the float32 state at 1e-4;
and, since K8 repeats the plain version's every float32 operation in its
order, bit for bit.  CPU tests model the kernel's order of the sum over
n against ``halving_sum``.
"""
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.kernels.mamba_scan.mamba_scan import (
    selective_scan, selective_scan_plain)
from repro_torch.kernels.rwkv6.ref import halving_sum
from repro_torch.launch import serve_lm
from repro_torch.models import api, convert, jamba, mamba
from repro_torch.train import serve_step

ARCH = "jamba-v0.1-52b"
SCAN_TOL = 1e-5
MODEL_TOL = 1e-4
CARD_F32_TOL = 1e-4
CARD_BF16_REL = 2.0 ** -6


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's Jamba model and selective-scan kernels, imported
    for this module only (the ``jax.experimental.enable_x64`` name is
    installed for the import and removed again with the ``repro`` modules
    on teardown)."""
    import jax
    import jax.experimental
    import jax.numpy as jnp
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro import configs
        from repro.kernels.mamba_scan import mamba_scan as spallas
        from repro.kernels.mamba_scan import ref as sref
        from repro.models import api as rapi
        from repro.models import jamba as rjamba
        from repro.models import mamba as rmamba
        from repro.train import serve_step as rserve
        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                    api=rapi, jamba=rjamba, mamba=rmamba,
                                    sref=sref, spallas=spallas, serve=rserve)
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
    return torch.device("cuda")


def _scan_inputs(bsz, t, dim, n, *, seed=0, dt="spread"):
    """x, dt (B, T, dim), b, c (B, T, N), a (dim, N), d (dim,), float32
    numpy.  ``dt``: "spread" (log-uniform in [1e-3, 1]), "small" (near
    1e-3), "large" (near 1) or "wide" (log-uniform in [1e-3, 100])."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, t, dim))
    lo, hi = {"spread": (1e-3, 1.0), "small": (8e-4, 1.2e-3),
              "large": (0.8, 1.2), "wide": (1e-3, 100.0)}[dt]
    delta = np.exp(rng.uniform(np.log(lo), np.log(hi), (bsz, t, dim)))
    b, c = (rng.standard_normal((bsz, t, n)) for _ in range(2))
    a = -np.tile(np.arange(1, n + 1), (dim, 1)) * rng.uniform(0.5, 1.5,
                                                              (dim, 1))
    d = rng.standard_normal(dim)
    return [z.astype(np.float32) for z in (x, delta, b, c, a, d)]


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol) -> float:
    got = got.detach().float().cpu().numpy() if torch.is_tensor(got) else got
    err = float(np.abs(_np(got) - _np(want)).max()) if _np(want).size else 0.
    assert err <= tol, err
    return err


def _torch(arrays, **kw):
    return [torch.from_numpy(a).to(**kw) for a in arrays]


# --- the scan (K8's plain version) ------------------------------------------

@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("t", [1, 77, 128, 256])
def test_scan_plain_matches_pallas_and_ref(ref, t, n):
    """y against the Pallas kernel (interpret mode; T = 77 is one chunk of
    its own) and ``ref.selective_scan``, with and without the state; the
    final state against ``ref.selective_scan(return_state=True)``."""
    arrays = _scan_inputs(2, t, 40, n, seed=t + n)
    want = ref.spallas.selective_scan(*arrays, interpret=True)
    ry, rh = ref.sref.selective_scan(*arrays, return_state=True)
    got = selective_scan(*_torch(arrays))
    y, h = scan_ops.selective_scan(*_torch(arrays), return_state=True)
    assert y.shape == (2, t, 40) and y.dtype == torch.float32
    assert h.shape == (2, 40, n) and h.dtype == torch.float32
    assert torch.equal(got, y)
    _close(y, want, SCAN_TOL)
    _close(y, ry, SCAN_TOL)
    _close(h, rh, SCAN_TOL)


@pytest.mark.parametrize("dt", ["small", "large"])
def test_scan_plain_matches_ref_at_extreme_steps(ref, dt):
    arrays = _scan_inputs(2, 150, 24, 16, seed=5, dt=dt)
    ry, rh = ref.sref.selective_scan(*arrays, return_state=True)
    y, h = selective_scan_plain(*_torch(arrays), return_state=True)
    _close(y, ry, SCAN_TOL)
    _close(h, rh, SCAN_TOL)


def test_scan_plain_bf16_matches_ref(ref):
    """bf16 x, dt, b and c: the same float32 scan, y rounded to bf16."""
    arrays = _scan_inputs(2, 50, 24, 8, seed=9)
    jb = [ref.jnp.asarray(a, ref.jnp.bfloat16) for a in arrays[:4]]
    ry, rh = ref.sref.selective_scan(*jb, *arrays[4:], return_state=True)
    y, h = selective_scan(*_torch(arrays[:4], dtype=torch.bfloat16),
                          *_torch(arrays[4:]), return_state=True)
    assert y.dtype == torch.bfloat16
    want = _np(ry.astype(ref.jnp.float32))
    assert np.abs(y.float().numpy() - want).max() <= 2 ** -7 * max(
        1.0, np.abs(want).max())
    _close(h, rh, SCAN_TOL)


def test_scan_step_matches_reference_and_scan(ref):
    x, dt, b, c, a, d = _scan_inputs(3, 12, 20, 16, seed=3)
    h0 = np.random.default_rng(4).standard_normal((3, 20, 16)).astype(
        np.float32)
    want_h, want_y = ref.sref.selective_scan_step(h0, x[:, 0], dt[:, 0],
                                                  b[:, 0], c[:, 0], a, d)
    got_h, got_y = scan_ops.selective_scan_step(*_torch(
        (h0, x[:, 0], dt[:, 0], b[:, 0], c[:, 0], a, d)))
    _close(got_h, want_h, SCAN_TOL)
    _close(got_y, want_y, SCAN_TOL)
    # T steps from h = 0 give the scan's output and state
    tx, tdt, tb, tc, ta, td = _torch((x, dt, b, c, a, d))
    h = torch.zeros(3, 20, 16)
    ys = []
    for i in range(12):
        h, y = scan_ref.selective_scan_step(h, tx[:, i], tdt[:, i], tb[:, i],
                                            tc[:, i], ta, td)
        ys.append(y)
    y, state = scan_ref.selective_scan(tx, tdt, tb, tc, ta, td,
                                       return_state=True)
    _close(torch.stack(ys, 1), y.numpy(), SCAN_TOL)
    _close(h, state.numpy(), SCAN_TOL)


def _kernel_sum(p):
    """Sum of p (R, N) over dim 1 in K8's order: the step's b and c come as
    the halves n < N/2 and n >= N/2, which the first level adds pairwise
    (h = N/2); then the halving tree of the N/2 nodes left."""
    h = p.shape[1] // 2
    q = [p[:, m] + p[:, m + h] for m in range(h)]
    h //= 2
    while h >= 1:
        q = [q[m] + q[m + h] for m in range(h)]
        h //= 2
    return q[0]


@pytest.mark.parametrize("n", [8, 16])
def test_scan_kernel_reduction_order_is_the_halving_tree(n):
    """The kernel's order of the sum over n gives ``halving_sum`` bit for
    bit on terms spread over twelve decades (where another order, left to
    right, rounds otherwise)."""
    rng = np.random.default_rng(n)
    p = torch.from_numpy((rng.standard_normal((4096, n)) * 10.0 ** rng.uniform(
        -6, 6, (4096, n))).astype(np.float32))
    want = halving_sum(p)
    assert torch.equal(_kernel_sum(p), want)
    left = p[:, 0]
    for m in range(1, n):
        left = left + p[:, m]
    assert not torch.equal(left, want)


@pytest.mark.parametrize("n", [8, 16])
def test_scan_kernel_model_matches_plain(n):
    """The recurrence with the kernel's sum order, step by step, is
    ``selective_scan_plain`` bit for bit: y and the final state, bf16 and
    float32."""
    for dt in (torch.float32, torch.bfloat16):
        arrays = _scan_inputs(2, 40, 24, n, seed=n + 1)
        args = _torch(arrays[:4], dtype=dt) + _torch(arrays[4:])
        want, wstate = selective_scan_plain(*args, return_state=True)
        xf, dtf, bf, cf = (z.float() for z in args[:4])
        a, d = args[4:]
        h = torch.zeros(2, 24, n)
        ys = []
        for t in range(40):
            decay = torch.exp(dtf[:, t, :, None] * a)
            h = decay * h + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t,
                                                                   None]
            hc = (h * cf[:, t, None]).reshape(-1, n)
            ys.append(_kernel_sum(hc).reshape(2, 24) + d * xf[:, t])
        assert torch.equal(torch.stack(ys, 1).to(dt), want)
        assert torch.equal(h, wstate)


def test_scan_wrapper_checks_inputs():
    x, dt, b, c, a, d = _torch(_scan_inputs(2, 5, 12, 8))
    before = dict(kernels.LAUNCHES)
    assert selective_scan(x, dt, b, c, a, d).shape == (2, 5, 12)
    assert kernels.LAUNCHES == before
    empty, state = selective_scan(x[:, :0], dt[:, :0], b[:, :0], c[:, :0],
                                  a, d, return_state=True)
    assert empty.shape == (2, 0, 12) and state.shape == (2, 12, 8)
    assert not state.any()
    with pytest.raises(ValueError, match="b and c"):
        selective_scan(x, dt, b, c[:, :4], a, d)
    with pytest.raises(ValueError, match="a must be"):
        selective_scan(x, dt, b, c, a[:, :4], d)
    with pytest.raises(TypeError, match="share one type"):
        selective_scan(x, dt.double(), b, c, a, d)
    with pytest.raises(TypeError, match="float32"):
        selective_scan(x, dt, b, c, a.double(), d)
    # meta tensors (the dry run): empty outputs of the plain version's
    # shapes and types
    meta = [z.to("meta") for z in (x, dt, b, c, a, d)]
    y, state = selective_scan(*meta, return_state=True)
    assert (y.device.type, y.shape, y.dtype) == ("meta", x.shape, x.dtype)
    assert (state.shape, state.dtype) == ((x.shape[0], x.shape[2],
                                           b.shape[2]), torch.float32)
    with pytest.raises(ValueError, match="one device"):
        selective_scan(*meta[:5], d)
    assert kernels.LAUNCHES == before


# --- the mixer and the model ------------------------------------------------

def _reference(ref, seed=0, arch=ARCH):
    """(JAX config, port config, JAX params, the port's model of them)."""
    rcfg, cfg = ref.configs.get_config(arch, True), get_config(arch, True)
    params = ref.api.get_model(rcfg).init(ref.jax.random.PRNGKey(seed), rcfg)
    model = convert.from_reference(
        ref.jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return rcfg, cfg, params, model


def test_from_reference_round_trip(ref):
    """Every JAX leaf lands in one port parameter: matrices transposed to
    (out, in), the expert stacks and the conv kept, the superblock axis and
    the second axis of the Mamba, MoE and dense stacks split off; nothing
    is left over on either side."""
    _, cfg, params, model = _reference(ref)
    assert isinstance(model, jamba.Jamba)
    state = model.state_dict()
    n_port = 0
    for path, leaf in ref.jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        leaf = _np(leaf)
        if keys[0] != "blocks":
            want = leaf.T if keys[0] == "lm_head" else leaf
            assert np.array_equal(state[keys[0]].numpy(), want), keys
            n_port += 1
            continue
        flip = keys[-1] in convert.TRANSPOSED
        for i in range(cfg.n_layers // jamba.SUPER):
            if keys[1] in ("mamba", "moe", "ff"):
                for j in range(leaf.shape[1]):
                    name = ".".join(["blocks", str(i), keys[1], str(j)]
                                    + keys[2:])
                    want = leaf[i, j].T if flip else leaf[i, j]
                    assert np.array_equal(state[name].numpy(), want), name
                    n_port += 1
            else:
                name = ".".join(["blocks", str(i)] + keys[1:])
                want = leaf[i].T if flip else leaf[i]
                assert np.array_equal(state[name].numpy(), want), name
                n_port += 1
    assert n_port == len(state)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_from_reference_refuses_missing_leaves(ref):
    _, cfg, params, _ = _reference(ref)
    params = ref.jax.tree_util.tree_map(np.asarray, params)
    blocks = params["blocks"]
    no_a = dict(params, blocks=dict(blocks, mamba={
        k: v for k, v in blocks["mamba"].items() if k != "a_log"}))
    with pytest.raises(RuntimeError, match="a_log"):
        convert.from_reference(no_a, cfg, device="cpu")
    narrow = dict(params, blocks=dict(blocks, mamba=dict(
        blocks["mamba"], d_skip=blocks["mamba"]["d_skip"][..., :-1])))
    with pytest.raises(RuntimeError, match="d_skip"):
        convert.from_reference(narrow, cfg, device="cpu")


def test_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(get_config(ARCH, True), d_model=256, d_state=16)
    p = mamba.Mamba(cfg)
    p.reset_parameters(torch.Generator().manual_seed(0))
    n, r = cfg.d_state, mamba.dt_rank(cfg)
    assert torch.equal(p.a_log, torch.log(torch.arange(
        1, n + 1, dtype=torch.float32)).expand(cfg.d_inner, n))
    step = torch.nn.functional.softplus(p.dt_bias)
    assert float(step.min()) >= 1e-3 * (1 - 1e-5)
    assert float(step.max()) <= 0.1 * (1 + 1e-5)
    assert float(step.mean()) == pytest.approx(0.05, rel=0.05)
    assert float(p.conv_w.std()) == pytest.approx(0.5, rel=0.05)
    assert float(p.in_proj.std()) == pytest.approx(256 ** -0.5, rel=0.05)
    assert float(p.dt_proj.std()) == pytest.approx(r ** -0.5, rel=0.05)
    assert bool((p.d_skip == 1).all() and (p.conv_b == 0).all())
    assert p.dt_proj.dtype == p.a_log.dtype == torch.float32


def test_mamba_apply_and_step_match_reference(ref):
    """One mixer of the smoke model: the stateless and the stateful
    forward, the conv and SSM states, and three decode steps from them."""
    rcfg, cfg, params, model = _reference(ref)
    mp = ref.jax.tree_util.tree_map(lambda a: a[0, 2],
                                    params["blocks"]["mamba"])
    p = model.blocks[0].mamba[2]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    _close(mamba.mamba_apply(p, torch.from_numpy(x), cfg),
           ref.mamba.mamba_apply(mp, x, rcfg), MODEL_TOL)
    want, (rconv, rssm) = ref.mamba.mamba_apply(mp, x, rcfg,
                                                return_state=True)
    got, (conv, ssm) = mamba.mamba_apply(p, torch.from_numpy(x), cfg,
                                         return_state=True)
    assert conv.shape == (2, cfg.d_conv - 1, cfg.d_inner)
    _close(got, want, MODEL_TOL)
    _close(conv, rconv, MODEL_TOL)
    _close(ssm, rssm, MODEL_TOL)
    rstate, state = (rconv, rssm), (conv, ssm)
    for i in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, rstate = ref.mamba.mamba_step(mp, xt, rcfg, rstate)
        got, state = mamba.mamba_step(p, torch.from_numpy(xt), cfg, state)
        _close(got, want, MODEL_TOL)
        _close(state[0], rstate[0], MODEL_TOL)
        _close(state[1], rstate[1], MODEL_TOL)


def test_prefill_and_decode_match_reference(ref):
    """Prefill logits and every state (conv, SSM, K and V), then 8 decode
    steps' logits teacher-forced on the reference's greedy tokens, within
    1e-4."""
    rcfg, cfg, params, model = _reference(ref)
    b, s, gen = 2, 37, 8
    batch = ref.api.synth_batch(3, rcfg, b, s)
    tokens = api.synth_batch(3, cfg, b, s, device="cpu")["tokens"]
    assert np.array_equal(tokens.numpy(), np.asarray(batch["tokens"]))
    max_len = s + gen
    rpre = ref.jax.jit(ref.serve.make_prefill_step(rcfg, max_len=max_len))
    rdec = ref.jax.jit(ref.serve.make_decode_step(rcfg))
    want, rstate = rpre(params, batch)
    got, state = serve_step.make_prefill_step(cfg, max_len=max_len)(
        model, {"tokens": tokens})
    nb = cfg.n_layers // jamba.SUPER
    assert got.shape == (b, 1, cfg.vocab) and state.index == s
    assert state.conv.shape == (nb, 7, b, cfg.d_conv - 1, cfg.d_inner)
    assert state.ssm.shape == (nb, 7, b, cfg.d_inner, cfg.d_state)
    assert state.k.shape == (nb, b, cfg.n_kv_heads, max_len, cfg.hd)
    assert state.ssm.dtype == torch.float32
    _close(got, want, MODEL_TOL)
    for key in ("conv", "ssm", "k", "v"):
        _close(getattr(state, key), rstate[key], MODEL_TOL)
    dec = serve_step.make_decode_step(cfg)
    nxt = ref.jnp.argmax(want[:, -1], -1)[:, None].astype(ref.jnp.int32)
    compared = 0
    for i in range(gen):
        rn, rstate, want = rdec(params, rstate, nxt,
                                ref.jax.random.PRNGKey(i))
        tn, new_state, got = dec(model, state,
                                 torch.from_numpy(np.array(nxt)))
        assert new_state is state                  # written in place
        _close(got, want, MODEL_TOL)
        top2 = np.sort(_np(want[:, -1]), axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MODEL_TOL
        assert np.array_equal(tn.numpy()[sure], np.asarray(rn)[sure])
        compared += int(sure.sum())
        nxt = rn
    assert compared > 0 and state.index == s + gen
    for key in ("conv", "ssm", "k", "v"):
        _close(getattr(state, key), rstate[key], MODEL_TOL)


def test_prompt_shorter_than_the_conv_window_raises():
    """The JAX decode fails on a conv window that comes out short; the port
    refuses such a prompt at prefill."""
    cfg = get_config(ARCH, smoke=True)
    model = jamba.init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((2, cfg.d_conv - 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="conv window"):
        jamba.prefill(model, tokens, cfg, max_len=10)
    logits, state = jamba.prefill(model, torch.zeros(
        (2, cfg.d_conv - 1), dtype=torch.int32), cfg, max_len=10)
    assert logits.shape == (2, 1, cfg.vocab) and state.index == cfg.d_conv - 1


def test_api_state_and_serve_lm_on_the_cpu():
    cfg = get_config(ARCH, smoke=True)
    model = api.get_model(cfg)
    assert model.init is jamba.init and model.prefill is jamba.prefill
    state = model.make_decode_state(cfg, 3, 99, device="cpu")
    nb = cfg.n_layers // jamba.SUPER
    assert state.conv.shape == (nb, 7, 3, cfg.d_conv - 1, cfg.d_inner)
    assert state.k.shape == (nb, 3, cfg.n_kv_heads, 99, cfg.hd)
    assert state.index == 0 and not state.ssm.any()
    before = dict(kernels.LAUNCHES)
    res = serve_lm.main(["--arch", ARCH, "--smoke", "--batch", "2",
                         "--prompt-len", "40", "--gen", "5", "--device",
                         "cpu"])
    assert res.seqs.shape == (2, 5) and res.logits_finite
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="superblocks"):
        serve_lm.serve(dataclasses.replace(cfg, n_layers=4), batch=2,
                       prompt_len=40, gen=5, device="cpu")


# --- on the card -------------------------------------------------------------

def _card_check(got, want, gstate, wstate):
    """Raise past the tolerances of the module docstring."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert gstate.dtype == torch.float32 and gstate.shape == wstate.shape
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        assert bool((diff <= CARD_BF16_REL * want.float().abs() + 1e-5).all())
    elif got.numel():
        scale = max(1.0, float(want.abs().max()))
        assert float(diff.max()) <= CARD_F32_TOL * scale
    assert float((gstate - wstate).abs().max()) <= CARD_F32_TOL


# (B, T, dim, N, Δ): one step; T = 77, no multiple of the staged chunk;
# dim = 200, no multiple of the block; N = 8 and 16; Δ near 1e-3 and 1;
# T = 0
GPU_SCAN = [(3, 1, 256, 16, "spread"), (2, 77, 200, 8, "spread"),
            (2, 77, 200, 16, "small"), (2, 300, 512, 16, "large"),
            (4, 1000, 384, 16, "spread"), (2, 33, 130, 8, "large"),
            (2, 0, 256, 16, "spread")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GPU_SCAN)
def test_gpu_selective_scan_matches_plain(cuda, case, dtype):
    bsz, t, dim, n, dt = case
    arrays = _scan_inputs(bsz, t, dim, n, seed=t + n, dt=dt)
    args = (_torch(arrays[:4], device=cuda, dtype=getattr(torch, dtype))
            + _torch(arrays[4:], device=cuda))
    before = kernels.LAUNCHES["selective_scan"]
    got, gstate = selective_scan(*args, return_state=True)
    stateless = selective_scan(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selective_scan"] == before + 2
    assert torch.equal(stateless, got)
    want, wstate = selective_scan_plain(*args, return_state=True)
    _card_check(got, want, gstate, wstate)


# T around the edges of the double-buffered staging's chunks (8 steps;
# 16 and 32 as well) and across many chunks; dim 200 (no multiple of the
# 128 channels of a block) and 8192 (Jamba's); N 8 and 16
GPU_EXACT_T = [0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 1000]
GPU_EXACT_DIM_N = [(200, 8), (200, 16), (8192, 8), (8192, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,n", GPU_EXACT_DIM_N)
@pytest.mark.parametrize("t", GPU_EXACT_T)
def test_gpu_selective_scan_bit_exact(cuda, t, dim, n, dtype):
    """K8 equals its plain version bit for bit, y and the final state,
    with and without the state."""
    arrays = _scan_inputs(2, t, dim, n, seed=t + dim + n)
    args = (_torch(arrays[:4], device=cuda, dtype=getattr(torch, dtype))
            + _torch(arrays[4:], device=cuda))
    got, gstate = selective_scan(*args, return_state=True)
    want, wstate = selective_scan_plain(*args, return_state=True)
    assert torch.equal(got, want) and torch.equal(gstate, wstate)
    assert torch.equal(selective_scan(*args), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_selective_scan_bit_exact_unaligned(cuda, dtype):
    """Inputs that do not allow the 16-byte copies (x and b start 4 bytes
    past an aligned address; dim 130, no multiple of 8) take the kernel's
    element-by-element staging, with the same bits."""
    dt = getattr(torch, dtype)
    for dim, shift in ((512, True), (130, False)):
        x, delta, b, c, a, d = _torch(_scan_inputs(2, 77, dim, 16, seed=dim),
                                      device=cuda, dtype=dt)
        if shift:
            pad = 4 // x.element_size()
            x = torch.empty(x.numel() + pad, dtype=dt, device=cuda)[
                pad:].view(x.shape).copy_(x)
            b = torch.empty(b.numel() + pad, dtype=dt, device=cuda)[
                pad:].view(b.shape).copy_(b)
            assert x.data_ptr() % 16 and x.is_contiguous()
        args = (x, delta, b, c, a.float(), d.float())
        got, gstate = selective_scan(*args, return_state=True)
        want, wstate = selective_scan_plain(*args, return_state=True)
        assert torch.equal(got, want) and torch.equal(gstate, wstate), dim


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 16])
def test_gpu_selective_scan_bit_exact_with_underflowing_exps(cuda, n, dtype):
    """Δ up to 100: exp(Δ·a) down to subnormals and zero, with the same
    bits."""
    arrays = _scan_inputs(2, 1000, 200, n, seed=n, dt="wide")
    assert (arrays[1][..., None] * arrays[4] < -104).any()
    args = (_torch(arrays[:4], device=cuda, dtype=getattr(torch, dtype))
            + _torch(arrays[4:], device=cuda))
    got, gstate = selective_scan(*args, return_state=True)
    want, wstate = selective_scan_plain(*args, return_state=True)
    assert torch.equal(got, want) and torch.equal(gstate, wstate)


@pytest.mark.gpu
def test_gpu_selective_scan_refuses_what_it_was_not_built_for(cuda):
    for n in (4, 12, 32):
        args = _torch(_scan_inputs(2, 5, 64, n), device=cuda)
        with pytest.raises(ValueError, match="state size"):
            selective_scan(*args)
    x, *rest = _torch(_scan_inputs(2, 5, 64, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(x.transpose(0, 1).contiguous().transpose(0, 1), *rest)


@pytest.mark.gpu
def test_gpu_model_matches_cpu(cuda):
    """Float32, the same weights: the card with K6, K7 and K8, the CPU with
    the plain versions; prefill, then decode teacher-forced on the CPU's
    greedy tokens."""
    cfg = get_config(ARCH, smoke=True)
    cpu = jamba.init(torch.Generator().manual_seed(0), cfg)
    card = jamba.Jamba(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = api.synth_batch(1, cfg, 2, 77, device="cpu")["tokens"]
    kernels.reset_launches()
    want, cstate = jamba.prefill(cpu, tokens, cfg, max_len=90)
    got, gstate = jamba.prefill(card, tokens.to(cuda), cfg, max_len=90)
    _close(got, want.numpy(), MODEL_TOL)
    _close(gstate.ssm, cstate.ssm.numpy(), MODEL_TOL)
    for _ in range(5):
        nxt = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        want, cstate = jamba.decode_step(cpu, cstate, nxt, cfg)
        got, gstate = jamba.decode_step(card, gstate, nxt.to(cuda), cfg)
        _close(got, want.numpy(), MODEL_TOL)
    nb = cfg.n_layers // jamba.SUPER
    assert kernels.LAUNCHES["selective_scan"] == 7 * nb
    assert kernels.LAUNCHES["flash_attention"] == nb
    assert kernels.LAUNCHES["decode_attention"] == 5 * nb


@pytest.mark.gpu
def test_gpu_serve_lm_runs_jamba(cuda):
    """``serve_lm`` on the card in bf16: per superblock 7 K8 launches and
    one K6 in the prefill, one K7 a decode step, and no host sync in the
    decode loop."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="bfloat16")
    kernels.reset_launches()
    res = serve_lm.serve(cfg, batch=3, prompt_len=100, gen=7)
    nb = cfg.n_layers // jamba.SUPER
    assert res.logits_finite and res.seqs.shape == (3, 7)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "selective_scan": 7 * nb, "flash_attention": nb,
        "decode_attention": 6 * nb}

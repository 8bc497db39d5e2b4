"""The port's RWKV6 serving path and its WKV kernel (K9) held against the
JAX package: the plain recurrence against the Pallas kernel, run in
interpret mode, and against ``ref.py``; the decode step; the parameter
conversion; and ``rwkv6-3b-smoke`` in float32 on the CPU, prefill logits,
final states and teacher-forced decode logits.

The JAX model never runs its Pallas kernel (``_time_mix`` takes the jnp
scan; hazard H9 in ROADMAP.md), so the model is compared with the JAX
model in float32 on the CPU, where the port runs the kernel's plain
version, and K9 with that plain version on the card (tests marked
``gpu``, which skip without one).

Tolerances.  The plain recurrence against the Pallas kernel and
``ref.wkv6``: 1e-5 absolute in float32.  The two sum over i in another
order, so they differ by a few units in the last place of the output; the
inputs are drawn at a scale (r, k and v N(0, 0.25), u as the model draws
it, the decay spread over (0, 1)) that keeps the outputs below 32, where a
float32 ulp is at most 3.8e-6.  Models: logits and states within 1e-4, the
dense LM's tolerance (``test_torch_lm.py``).  On the card, K9 against its
plain version: 1e-4 absolute in float32, on the output and the final
state; in bf16 the output's max |got - want| / max |want| at 1e-2, since
the output grows with T and one bf16 ulp of it can be several units, and
the float32 state at 1e-4 absolute.  K9 repeats its plain version's float32
operations in their order, so beside those tolerances it is also held equal
to it bit for bit; a CPU test models the kernel's row-to-thread map and its
reduction order (the tiling read from ``csrc/wkv6.cu``) against
``ref.halving_sum``.
"""
import dataclasses
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.kernels.rwkv6.wkv6 import wkv6, wkv6_plain
from repro_torch.launch import serve_lm
from repro_torch.models import api, convert, rwkv6
from repro_torch.train import serve_step

ARCH = "rwkv6-3b"
WKV_TOL = 1e-5
MODEL_TOL = 1e-4
CARD_F32_TOL = 1e-4
CARD_BF16_REL = 1e-2


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's RWKV6 model and WKV kernels, imported for this
    module only (the ``jax.experimental.enable_x64`` name is installed for
    the import and removed again with the ``repro`` modules on teardown)."""
    import jax
    import jax.experimental
    import jax.numpy as jnp
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro import configs
        from repro.kernels.rwkv6 import ref as wref
        from repro.kernels.rwkv6 import rwkv6 as wpallas
        from repro.models import api as rapi
        from repro.models import rwkv6 as rmodel
        from repro.train import serve_step as rserve
        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                    api=rapi, model=rmodel, wref=wref,
                                    wpallas=wpallas, serve=rserve)
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


def _wkv_inputs(bh, t, d, *, seed=0, decay="spread"):
    """r, k, v (BH, T, D) N(0, 0.25), w in (0, 1), u (BH, D) N(0, 0.01),
    float32 numpy.  ``decay``: "spread" (exp(-exp(N(-2, 1.5)))), "near0"
    or "near1"."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((bh, t, d)) for _ in range(3))
    logw = {"spread": rng.normal(-2.0, 1.5, (bh, t, d)),
            "near0": rng.normal(2.0, 0.5, (bh, t, d)),
            "near1": rng.normal(-6.0, 0.5, (bh, t, d))}[decay]
    w = np.exp(-np.exp(logw))
    u = 0.1 * rng.standard_normal((bh, d))
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol) -> float:
    got = got.detach().float().cpu().numpy() if torch.is_tensor(got) else got
    err = float(np.abs(_np(got) - _np(want)).max()) if _np(want).size else 0.
    assert err <= tol, err
    return err


# --- the recurrence (K9's plain version) --------------------------------------

@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("t", [1, 77, 128, 256])
def test_wkv6_plain_matches_pallas_and_ref(ref, t, d):
    """Output against the Pallas kernel (interpret mode) and ``ref.wkv6``;
    the final state against ``ref.wkv6(return_state=True)``.  T = 77 is a
    length the Pallas kernel takes only as one chunk."""
    arrays = _wkv_inputs(3, t, d, seed=t + d)
    want = ref.wpallas.wkv6(*arrays, interpret=True)
    rout, rstate = ref.wref.wkv6(*arrays, return_state=True)
    got, state = wkv6(*(torch.from_numpy(a) for a in arrays),
                      return_state=True)
    assert got.shape == (3, t, d) and got.dtype == torch.float32
    assert state.shape == (3, d, d) and state.dtype == torch.float32
    _close(got, want, WKV_TOL)
    _close(got, rout, WKV_TOL)
    _close(state, rstate, WKV_TOL)


@pytest.mark.parametrize("decay", ["near0", "near1"])
def test_wkv6_plain_matches_ref_at_extreme_decays(ref, decay):
    arrays = _wkv_inputs(2, 200, 16, seed=5, decay=decay)
    rout, rstate = ref.wref.wkv6(*arrays, return_state=True)
    got, state = wkv6_plain(*(torch.from_numpy(a) for a in arrays),
                            return_state=True)
    _close(got, rout, WKV_TOL)
    _close(state, rstate, WKV_TOL)


def test_wkv6_plain_bf16_matches_ref(ref):
    """bf16 inputs: the same float32 scan, the output rounded to bf16."""
    arrays = _wkv_inputs(3, 50, 16, seed=9)
    jb = [ref.jnp.asarray(a, ref.jnp.bfloat16) for a in arrays]
    rout, rstate = ref.wref.wkv6(*jb, return_state=True)
    got, state = wkv6(*(torch.from_numpy(a).to(torch.bfloat16)
                        for a in arrays), return_state=True)
    assert got.dtype == torch.bfloat16
    want = _np(rout.astype(ref.jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= 2 ** -7 * max(
        1.0, np.abs(want).max())
    _close(state, rstate, WKV_TOL)


def test_wkv6_step_matches_reference_and_scan(ref):
    arrays = _wkv_inputs(4, 12, 16, seed=3)
    r, k, v, w, u = arrays
    s0 = np.random.default_rng(4).standard_normal((4, 16, 16)).astype(
        np.float32)
    want_s, want_o = ref.wref.wkv6_step(s0, r[:, 0], k[:, 0], v[:, 0],
                                        w[:, 0], u)
    got_s, got_o = wkv_ops.wkv6_step(*(torch.from_numpy(a) for a in (
        s0, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u)))
    _close(got_s, want_s, WKV_TOL)
    _close(got_o, want_o, WKV_TOL)
    # T steps from S = 0 give the scan's output and state
    tr = [torch.from_numpy(a) for a in arrays]
    s = torch.zeros(4, 16, 16)
    outs = []
    for i in range(12):
        s, o = wkv_ref.wkv6_step(s, tr[0][:, i], tr[1][:, i], tr[2][:, i],
                                 tr[3][:, i], tr[4])
        outs.append(o)
    out, state = wkv_ref.wkv6(*tr, return_state=True)
    _close(torch.stack(outs, 1), out.numpy(), WKV_TOL)
    _close(s, state.numpy(), WKV_TOL)


def test_halving_sum_is_a_sum_in_a_fixed_order():
    x = torch.randn(3, 13, 5, dtype=torch.float64)
    assert torch.allclose(wkv_ref.halving_sum(x), x.sum(dim=1))
    # the tree of 4: (x0 + x2) + (x1 + x3)
    y = torch.tensor([[1e8, 1.0, -1e8, 1.0]], dtype=torch.float32)[..., None]
    assert float(wkv_ref.halving_sum(y)) == 2.0


def _built_tiles() -> dict:
    """{D: (M, C, JB, CHUNK)}: the tiling ``csrc/wkv6.cu`` is built with."""
    src = (Path(kernels.__file__).parent / "csrc" / "wkv6.cu").read_text()
    found = re.findall(r"struct Tile<(\d+)> \{\s*static constexpr int "
                       r"M = (\d+), C = (\d+), JB = (\d+), CHUNK = (\d+);",
                       src)
    return {int(d): tuple(int(x) for x in t) for d, *t in found}


def _kernel_sum(p, m_rows, *, contiguous=False):
    """Sum of p (BH, D, D) over dim 1 in the kernel's order.  Row i is
    staged at residue i % R, slot i // R (R = D / M residues of M slots);
    the threads of residue ri read its slots 0..M-1 and so hold rows
    ri + R·m.  Each thread adds row m + M/2 to row m as the rows come and
    halves its M/2 sums in place; then node i of the R residues' nodes adds
    node i + h, i < h, for h = R/2 .. 1.  ``contiguous`` gives residue ri
    rows ri·M .. ri·M + M - 1 instead: a map the halving tree does not
    allow."""
    d = p.shape[1]
    r = d // m_rows
    staged = {(i % r) * m_rows + i // r: i for i in range(d)}
    nodes = []
    for ri in range(r):
        rows = ([ri * m_rows + m for m in range(m_rows)] if contiguous else
                [staged[ri * m_rows + m] for m in range(m_rows)])
        q = [p[:, i] for i in rows[:m_rows // 2]]
        for m in range(m_rows // 2, m_rows):
            q[m - m_rows // 2] = q[m - m_rows // 2] + p[:, rows[m]]
        h = m_rows // 4
        while h >= 1:
            q = [q[m] + q[m + h] for m in range(h)] + q[h:]
            h //= 2
        nodes.append(q[0])
    h = r // 2
    while h >= 1:
        nodes = [nodes[i] + nodes[i + h] for i in range(h)] + nodes[h:]
        h //= 2
    return nodes[0]


def test_wkv6_kernel_tiles_are_read():
    tiles = _built_tiles()
    assert set(tiles) == {16, 64}
    for d, (m, c, jb, chunk) in tiles.items():
        r, lanes = d // m, jb // c
        assert m % 4 == 0 and r & (r - 1) == 0 and r <= 32
        assert c in (1, 2, 4) and d % jb == 0 and jb % c == 0
        assert (32 % lanes == 0 or lanes % 32 == 0) and r * lanes % 32 == 0
        assert chunk > 0


@pytest.mark.parametrize("d", [16, 64])
def test_wkv6_kernel_reduction_order_is_the_halving_tree(d):
    """The kernel's row-to-thread map and reduction order, at the tiling
    it is built with, give ``ref.halving_sum`` bit for bit on terms spread
    over twelve decades (where another order rounds otherwise, as the
    contiguous map shows)."""
    m_rows = _built_tiles()[d][0]
    rng = np.random.default_rng(d)
    p = torch.from_numpy((rng.standard_normal((5, d, d)) * 10.0 ** rng.uniform(
        -6, 6, (5, d, d))).astype(np.float32))
    want = wkv_ref.halving_sum(p)
    assert torch.equal(_kernel_sum(p, m_rows), want)
    assert not torch.equal(_kernel_sum(p, m_rows, contiguous=True), want)


@pytest.mark.parametrize("d", [16, 64])
def test_wkv6_kernel_model_matches_plain(d):
    """The recurrence with the kernel's reduction order, step by step, is
    ``wkv6_plain`` bit for bit: output and final state, bf16 and float32."""
    m_rows = _built_tiles()[d][0]
    for dt in (torch.float32, torch.bfloat16):
        r, k, v, w, u = (torch.from_numpy(a).to(dt)
                         for a in _wkv_inputs(3, 9, d, seed=d + 1))
        want, wstate = wkv6_plain(r, k, v, w, u, return_state=True)
        rf, kf, vf, wf, uf = (z.float() for z in (r, k, v, w, u))
        s = torch.zeros(3, d, d)
        outs = []
        for t in range(9):
            kv = kf[:, t, :, None] * vf[:, t, None, :]
            outs.append(_kernel_sum((s + uf[:, :, None] * kv) *
                                    rf[:, t, :, None], m_rows))
            s = wf[:, t, :, None] * s + kv
        assert torch.equal(torch.stack(outs, 1).to(dt), want)
        assert torch.equal(s, wstate)


def test_wkv6_wrapper_checks_inputs():
    r, k, v, w, u = (torch.from_numpy(a) for a in _wkv_inputs(2, 5, 16))
    before = dict(kernels.LAUNCHES)
    out = wkv6(r, k, v, w, u)
    assert out.shape == (2, 5, 16) and kernels.LAUNCHES == before
    empty, state = wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u,
                        return_state=True)
    assert empty.shape == (2, 0, 16) and not state.any()
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, w, u[:, :8])
    with pytest.raises(ValueError, match="BH, T, D"):
        wkv6(r, k[:, :4], v, w, u)
    with pytest.raises(TypeError):
        wkv6(r, k, v, w.double(), u)
    # meta tensors (the dry run): empty outputs of the plain version's
    # shapes and types
    meta = [t.to("meta") for t in (r, k, v, w, u)]
    out, state = wkv6(*meta, return_state=True)
    assert (out.device.type, out.shape, out.dtype) == ("meta", r.shape,
                                                       r.dtype)
    assert (state.shape, state.dtype) == ((r.shape[0], r.shape[2],
                                           r.shape[2]), torch.float32)
    with pytest.raises(ValueError, match="one device"):
        wkv6(*meta[:4], u)
    assert kernels.LAUNCHES == before


# --- the model ---------------------------------------------------------------

def _reference(ref, seed=0):
    """(JAX config, port config, JAX params, the port's model of them)."""
    rcfg, cfg = ref.configs.get_config(ARCH, True), get_config(ARCH, True)
    params = ref.api.get_model(rcfg).init(ref.jax.random.PRNGKey(seed), rcfg)
    model = convert.from_reference(
        ref.jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return rcfg, cfg, params, model


def test_from_reference_round_trip(ref):
    """Every JAX leaf lands in one port parameter: matrices transposed to
    (out, in), per-layer leaves split off the layer axis; nothing is left
    over on either side."""
    _, cfg, params, model = _reference(ref)
    assert isinstance(model, rwkv6.RWKV6)
    state = model.state_dict()
    n_port = 0
    for path, leaf in ref.jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        leaf = _np(leaf)
        if keys[0] != "layers":
            want = leaf.T if keys[0] == "lm_head" else leaf
            assert np.array_equal(state[keys[0]].numpy(), want), keys
            n_port += 1
            continue
        name = keys[1]
        for i in range(cfg.n_layers):
            got = state[f"layers.{i}.{name}"].numpy()
            want = leaf[i].T if name.endswith(("proj", "lora_a",
                                               "lora_b")) else leaf[i]
            assert np.array_equal(got, want), (name, i)
            n_port += 1
    assert n_port == len(state)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_from_reference_refuses_missing_leaves(ref):
    _, cfg, params, _ = _reference(ref)
    params = ref.jax.tree_util.tree_map(np.asarray, params)
    no_u = dict(params, layers={k: v for k, v in params["layers"].items()
                                if k != "u"})
    with pytest.raises(RuntimeError, match="u"):
        convert.from_reference(no_u, cfg, device="cpu")


def test_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(get_config(ARCH, True), d_model=256,
                              d_ff=512, n_layers=1)
    model = rwkv6.init(torch.Generator().manual_seed(0), cfg)
    lp = model.layers[0]
    assert float(lp.r_proj.std()) == pytest.approx(256 ** -0.5, rel=0.05)
    assert float(lp.cv_proj.std()) == pytest.approx(512 ** -0.5, rel=0.05)
    assert float(lp.w_lora_b.std()) == pytest.approx(0.01, rel=0.05)
    assert float(lp.u.std()) == pytest.approx(0.1, rel=0.1)
    assert bool((lp.w0 == -6).all() and (lp.mu_w == 0.5).all())
    assert lp.u.shape == (256 // cfg.rwkv_head_dim, cfg.rwkv_head_dim)


def test_time_and_channel_mix_match_reference(ref):
    rcfg, cfg, params, model = _reference(ref)
    lp = ref.jax.tree_util.tree_map(lambda a: a[1], params["layers"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    tx, tprev = torch.from_numpy(x), torch.from_numpy(prev)
    want, wtm, _ = ref.model._time_mix(lp, x, rcfg, prev, None)
    got, gtm, gs = rwkv6._time_mix(model.layers[1], tx, cfg, tprev, None)
    assert gs is None
    _close(got, want, MODEL_TOL)
    _close(gtm, wtm, 0.0)
    want, wcm = ref.model._channel_mix(lp, x, prev, np.float32)
    got, gcm = rwkv6._channel_mix(model.layers[1], tx, tprev, torch.float32)
    _close(got, want, MODEL_TOL)
    _close(gcm, wcm, 0.0)
    _close(rwkv6._decay(model.layers[1], tx, torch.float32),
           ref.model._decay(lp, x, np.float32), MODEL_TOL)


def test_forward_matches_reference(ref):
    """The stateless forward (the path that runs K9 on the card without a
    state) against the JAX forward."""
    rcfg, cfg, params, model = _reference(ref)
    tokens = api.synth_batch(5, cfg, 2, 40, device="cpu")["tokens"]
    want = ref.model.forward(params, tokens.numpy(), rcfg)
    _close(rwkv6.forward(model, tokens, cfg), want, MODEL_TOL)


def test_prefill_and_decode_match_reference(ref):
    """Prefill logits and the final tm/cm/wkv states, then 8 decode steps'
    logits teacher-forced on the reference's greedy tokens, within 1e-4."""
    rcfg, cfg, params, model = _reference(ref)
    b, s, gen = 2, 37, 8
    batch = ref.api.synth_batch(3, rcfg, b, s)
    tokens = api.synth_batch(3, cfg, b, s, device="cpu")["tokens"]
    assert np.array_equal(tokens.numpy(), np.asarray(batch["tokens"]))
    rpre = ref.jax.jit(ref.serve.make_prefill_step(rcfg, max_len=s + gen))
    rdec = ref.jax.jit(ref.serve.make_decode_step(rcfg))
    want, rstate = rpre(params, batch)
    got, state = serve_step.make_prefill_step(cfg, max_len=s + gen)(
        model, {"tokens": tokens})
    assert got.shape == (b, 1, cfg.vocab)
    nh, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert state.wkv.shape == (cfg.n_layers, b, nh, hd, hd)
    assert state.wkv.dtype == torch.float32
    _close(got, want, MODEL_TOL)
    for key in ("tm", "cm", "wkv"):
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
    assert compared > 0
    for key in ("tm", "cm", "wkv"):
        _close(getattr(state, key), rstate[key], MODEL_TOL)


def test_prefill_of_one_token_takes_the_step(ref):
    """A one-token prompt goes through ``wkv6_step`` from the zero state,
    as in the JAX model, and gives its logits."""
    rcfg, cfg, params, model = _reference(ref)
    batch = ref.api.synth_batch(8, rcfg, 3, 1)
    want, rstate = ref.model.prefill(params, batch["tokens"], rcfg)
    got, state = rwkv6.prefill(model, torch.from_numpy(
        np.array(batch["tokens"])), cfg)
    _close(got, want, MODEL_TOL)
    _close(state.wkv, rstate["wkv"], MODEL_TOL)


def test_api_state_and_serve_lm_on_the_cpu():
    cfg = get_config(ARCH, smoke=True)
    model = api.get_model(cfg)
    assert model.init is rwkv6.init and model.prefill is rwkv6.prefill
    state = model.make_decode_state(cfg, 3, 99, device="cpu")
    nh = cfg.d_model // cfg.rwkv_head_dim
    assert state.tm.shape == state.cm.shape == (cfg.n_layers, 3, cfg.d_model)
    assert state.wkv.shape == (cfg.n_layers, 3, nh, cfg.rwkv_head_dim,
                               cfg.rwkv_head_dim)
    assert not state.wkv.any()
    before = dict(kernels.LAUNCHES)
    res = serve_lm.main(["--arch", ARCH, "--smoke", "--batch", "2",
                         "--prompt-len", "77", "--gen", "5", "--device",
                         "cpu"])
    assert res.seqs.shape == (2, 5) and res.logits_finite
    assert kernels.LAUNCHES == before


# --- on the card -------------------------------------------------------------

def _card_errors(got, want, gstate, wstate):
    """(output abs err, output rel err, state abs err)."""
    diff = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    mag = float(want.float().abs().max()) if want.numel() else 0.0
    serr = float((gstate - wstate).abs().max())
    return diff, diff / max(mag, 1e-30), serr


# (BH, T, D, decay): one step; T = 77, which no chunk of 32 divides; the
# served head dim at several chunk counts; w near 0 and near 1; D = 16 at
# one chunk and a step; T = 0
GPU_WKV = [(6, 1, 64, "spread"), (6, 77, 16, "spread"),
           (5, 77, 64, "near0"), (5, 300, 64, "near1"),
           (4, 1000, 64, "spread"), (3, 33, 16, "spread"),
           (3, 0, 64, "spread")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GPU_WKV)
def test_gpu_wkv6_matches_plain(cuda, case, dtype):
    bh, t, d, decay = case
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(cuda, dt)
            for a in _wkv_inputs(bh, t, d, seed=t, decay=decay)]
    before = kernels.LAUNCHES["wkv6"]
    got, gstate = wkv6(*args, return_state=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wkv6"] == before + 1
    want, wstate = wkv6_plain(*args, return_state=True)
    assert got.dtype == want.dtype == dt and gstate.dtype == torch.float32
    abs_err, rel_err, s_err = _card_errors(got, want, gstate, wstate)
    assert s_err <= CARD_F32_TOL
    if dt == torch.float32:
        assert abs_err <= CARD_F32_TOL
    else:
        assert rel_err <= CARD_BF16_REL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GPU_WKV)
def test_gpu_wkv6_bit_exact(cuda, case, dtype):
    """K9 equals its plain version bit for bit, output and final state."""
    bh, t, d, decay = case
    args = [torch.from_numpy(a).to(cuda, getattr(torch, dtype))
            for a in _wkv_inputs(bh, t, d, seed=t, decay=decay)]
    got, gstate = wkv6(*args, return_state=True)
    want, wstate = wkv6_plain(*args, return_state=True)
    assert torch.equal(got, want) and torch.equal(gstate, wstate)


@pytest.mark.gpu
def test_gpu_wkv6_bit_exact_at_served_shape(cuda):
    """RWKV6-3B's served prefill shape: batch 8 × 40 heads, T 1024, D 64,
    bf16, seeded inputs."""
    args = [torch.from_numpy(a).to(cuda, torch.bfloat16)
            for a in _wkv_inputs(320, 1024, 64, seed=22)]
    got, gstate = wkv6(*args, return_state=True)
    want, wstate = wkv6_plain(*args, return_state=True)
    assert torch.equal(got, want) and torch.equal(gstate, wstate)


@pytest.mark.gpu
def test_gpu_wkv6_refuses_what_it_was_not_built_for(cuda):
    for d in (24, 32):
        args = [torch.from_numpy(a).to(cuda) for a in _wkv_inputs(2, 5, d)]
        with pytest.raises(ValueError, match="head dim"):
            wkv6(*args)
    args = [torch.from_numpy(a).to(cuda) for a in _wkv_inputs(2, 5, 16)]
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])


@pytest.mark.gpu
def test_gpu_model_matches_cpu(cuda):
    """Float32, the same weights: the card with K9, the CPU with the plain
    version; the stateless forward, then prefill and decode teacher-forced
    on the CPU's greedy tokens."""
    cfg = get_config(ARCH, smoke=True)
    cpu = rwkv6.init(torch.Generator().manual_seed(0), cfg)
    card = rwkv6.RWKV6(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = api.synth_batch(1, cfg, 2, 77, device="cpu")["tokens"]
    kernels.reset_launches()
    _close(rwkv6.forward(card, tokens.to(cuda), cfg),
           rwkv6.forward(cpu, tokens, cfg).numpy(), MODEL_TOL)
    assert kernels.LAUNCHES["wkv6"] == cfg.n_layers
    want, cstate = rwkv6.prefill(cpu, tokens, cfg)
    got, gstate = rwkv6.prefill(card, tokens.to(cuda), cfg)
    _close(got, want.numpy(), MODEL_TOL)
    _close(gstate.wkv, cstate.wkv.numpy(), MODEL_TOL)
    for _ in range(5):
        nxt = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        want, cstate = rwkv6.decode_step(cpu, cstate, nxt, cfg)
        got, gstate = rwkv6.decode_step(card, gstate, nxt.to(cuda), cfg)
        _close(got, want.numpy(), MODEL_TOL)
    assert kernels.LAUNCHES["wkv6"] == 2 * cfg.n_layers


@pytest.mark.gpu
def test_gpu_serve_lm_runs_rwkv6(cuda):
    """``serve_lm`` on the card: one K9 launch per layer in the prefill, no
    other kernel, and no host sync in the decode loop."""
    kernels.reset_launches()
    res = serve_lm.main(["--arch", ARCH, "--smoke", "--batch", "3",
                         "--prompt-len", "100", "--gen", "7"])
    cfg = get_config(ARCH, smoke=True)
    assert res.logits_finite and res.seqs.shape == (3, 7)
    assert kernels.LAUNCHES == dict(kernels.LAUNCHES, wkv6=cfg.n_layers) \
        and sum(kernels.LAUNCHES.values()) == cfg.n_layers

"""The port's MoE layer and the moe family (Qwen2-MoE, Qwen3-MoE) held
against the JAX package, in float32 on the CPU: ``moe_apply`` with and
without shared experts and with padding experts, the parameter
conversion and initial draws, and both smoke models' prefill logits, KV
caches and teacher-forced decode logits.

The JAX package's single-device ``moe_apply`` runs ``ragged_dot``, a plain
XLA product, where the port runs ``torch._grouped_mm`` (ROADMAP hazard
H11); no Pallas kernel is on this path.  Tolerances: the layer's output
within 1e-5 (float32 sums of depth up to 64 taken in another order, at
outputs of order 1), its aux loss within 1e-6; models within 1e-4, the
dense LM's tolerance (``test_torch_lm.py``).  The tests marked ``gpu`` run
the model on the card against the CPU and serve it with its decode loop
under sync debug mode "error".
"""
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.launch import serve_lm
from repro_torch.models import api, convert, moe, transformer
from repro_torch.train import serve_step

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
LAYER_TOL = 1e-5
AUX_TOL = 1e-6
MODEL_TOL = 1e-4


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's MoE layer and models, imported for this module
    only (the ``jax.experimental.enable_x64`` name is installed for the
    import and removed again with the ``repro`` modules on teardown)."""
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
        from repro.models import moe as rmoe
        from repro.train import serve_step as rserve
        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                    api=rapi, moe=rmoe, serve=rserve)
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


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol) -> float:
    got = got.detach().float().cpu().numpy() if torch.is_tensor(got) else got
    err = float(np.abs(_np(got) - _np(want)).max()) if _np(want).size else 0.
    assert err <= tol, err
    return err


# name -> config overrides of the qwen2-moe smoke config: 4 experts padded
# to 16, with and without the shared expert; Qwen3's 16 experts top 8 (no
# padding, no shared expert)
LAYERS = {
    "padded, shared": dict(n_experts=4, top_k=2),
    "padded, no shared": dict(n_experts=4, top_k=2, n_shared=0,
                              d_shared=0),
    "16 experts top 8": dict(n_experts=16, top_k=8, n_shared=0, d_shared=0,
                             d_expert=24),
}


def _load(module, tree):
    """Fill one port module from the JAX package's dict of its
    parameters, strictly, with ``convert``'s layout mapping."""
    state = {k: torch.tensor(convert._port(k, v))
             for k, v in convert._leaves(tree)}
    module.load_state_dict(state, strict=True)
    return module


def _layer(ref, name, seed=0):
    """(JAX config, port config, JAX params of one MoE layer, the port's
    MoE holding them)."""
    over = LAYERS[name]
    rcfg = dataclasses.replace(
        ref.configs.get_config("qwen2-moe-a2.7b", True), **over)
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", True), **over)
    params = ref.moe.moe_init(ref.jax.random.PRNGKey(seed), rcfg)
    p = _load(moe.MoE(cfg, device="cpu"), params)
    return rcfg, cfg, params, p


@pytest.mark.parametrize("name", list(LAYERS))
@pytest.mark.parametrize("shape", [(2, 13), (5, 1)])
def test_moe_apply_matches_reference(ref, name, shape):
    """Output and aux loss against the JAX layer, at a prefill's and at a
    decode step's shape."""
    rcfg, cfg, params, p = _layer(ref, name)
    assert p.e_wi.shape[0] == moe.padded_experts(cfg) == 16
    assert (p.shared is None) == (cfg.n_shared == 0)
    x = np.random.default_rng(1).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    want, raux = ref.moe.moe_apply(params, x, rcfg)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    assert got.shape == shape + (cfg.d_model,) and aux.dtype == torch.float32
    _close(got, want, LAYER_TOL)
    _close(aux, raux, AUX_TOL)


def test_grouped_products_equal_a_per_expert_loop():
    """The sorted grouped products give, for every token, the gate-weighted
    sum of its top-k experts' SwiGLU outputs, computed one token and one
    expert at a time."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", True),
                              n_shared=0, d_shared=0)
    p = moe.MoE(cfg)
    p.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.randn(3, 7, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    got, _ = moe.moe_apply(p, x, cfg)
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(torch.nn.functional.linear(xf, p.router)
                          [:, :cfg.n_experts], dim=-1)
    gates, idx = probs.topk(cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for g, e in zip(gates[t], idx[t]):
            h = (torch.nn.functional.silu(xf[t] @ p.e_wg[e])
                 * (xf[t] @ p.e_wi[e]))
            want[t] += g * (h @ p.e_wd[e])
    _close(got.reshape(-1, cfg.d_model), want.numpy(), LAYER_TOL)


def test_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", True),
                              d_model=256, d_expert=128, n_experts=12)
    p = moe.MoE(cfg)
    p.reset_parameters(torch.Generator().manual_seed(0))
    assert p.router.shape == (16, 256) and p.router.dtype == torch.float32
    assert float(p.router.std()) == pytest.approx(256 ** -0.5, rel=0.05)
    for w, fan_in in ((p.e_wi, 256), (p.e_wg, 256), (p.e_wd, 128)):
        assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.05)
    assert p.shared_gate.shape == (1, 256)
    assert float(p.shared.wd.std()) == pytest.approx(
        cfg.d_shared ** -0.5, rel=0.05)


def _reference(ref, arch, seed=0):
    """(JAX config, port config, JAX params, the port's model of them)."""
    rcfg, cfg = ref.configs.get_config(arch, True), get_config(arch, True)
    params = ref.api.get_model(rcfg).init(ref.jax.random.PRNGKey(seed), rcfg)
    model = convert.from_reference(
        ref.jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return rcfg, cfg, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_round_trip(ref, arch):
    """Every JAX leaf lands in one port parameter: matrices transposed to
    (out, in), the expert stacks kept in their (E, in, out) layout, the
    layer axis split off; nothing is left over on either side."""
    _, cfg, params, model = _reference(ref, arch)
    assert isinstance(model, transformer.Transformer)
    state = model.state_dict()
    n_port = 0
    for path, leaf in ref.jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        leaf = _np(leaf)
        flip = keys[-1] in convert.TRANSPOSED
        if keys[0] != "layers":
            want = leaf.T if flip else leaf
            assert np.array_equal(state[keys[0]].numpy(), want), keys
            n_port += 1
            continue
        for i in range(cfg.n_layers):
            name = ".".join(["layers", str(i)] + keys[1:])
            want = leaf[i].T if flip else leaf[i]
            assert np.array_equal(state[name].numpy(), want), name
            n_port += 1
    assert n_port == len(state)
    assert state["layers.0.moe.e_wi"].shape == (
        moe.padded_experts(cfg), cfg.d_model, cfg.d_expert)


def test_from_reference_refuses_missing_or_misshapen(ref):
    _, cfg, params, _ = _reference(ref, "qwen2-moe-a2.7b")
    params = ref.jax.tree_util.tree_map(np.asarray, params)
    lay = params["layers"]
    no_gate = dict(params, layers=dict(lay, moe={
        k: v for k, v in lay["moe"].items() if k != "shared_gate"}))
    with pytest.raises(RuntimeError, match="shared_gate"):
        convert.from_reference(no_gate, cfg, device="cpu")
    unpadded = dict(params, layers=dict(lay, moe=dict(
        lay["moe"], e_wd=lay["moe"]["e_wd"][:, :cfg.n_experts])))
    with pytest.raises(RuntimeError, match="e_wd"):
        convert.from_reference(unpadded, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref, arch):
    """Prefill logits and the KV cache, then 8 decode steps' logits
    teacher-forced on the reference's greedy tokens, within 1e-4."""
    rcfg, cfg, params, model = _reference(ref, arch)
    b, s, gen = 2, 24, 8
    batch = ref.api.synth_batch(3, rcfg, b, s)
    tokens = api.synth_batch(3, cfg, b, s, device="cpu")["tokens"]
    max_len = s + gen + 1
    rpre = ref.jax.jit(ref.serve.make_prefill_step(rcfg, max_len=max_len))
    rdec = ref.jax.jit(ref.serve.make_decode_step(rcfg))
    want, rstate = rpre(params, batch)
    got, state = serve_step.make_prefill_step(cfg, max_len=max_len)(
        model, {"tokens": tokens})
    _close(got, want, MODEL_TOL)
    _close(state.k, rstate.k, MODEL_TOL)
    dec = serve_step.make_decode_step(cfg)
    nxt = ref.jnp.argmax(want[:, -1], -1)[:, None].astype(ref.jnp.int32)
    compared = 0
    for i in range(gen):
        rn, rstate, want = rdec(params, rstate, nxt,
                                ref.jax.random.PRNGKey(i))
        tn, state, got = dec(model, state, torch.from_numpy(np.array(nxt)))
        _close(got, want, MODEL_TOL)
        top2 = np.sort(_np(want[:, -1]), axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MODEL_TOL
        assert np.array_equal(tn.numpy()[sure], np.asarray(rn)[sure])
        compared += int(sure.sum())
        nxt = rn
    assert compared > 0 and state.index == s + gen
    _close(state.v, rstate.v, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_api_and_serve_lm_on_the_cpu(arch):
    cfg = get_config(arch, smoke=True)
    model = api.get_model(cfg)
    assert model.init is transformer.init
    assert isinstance(model.init(torch.Generator().manual_seed(0), cfg)
                      .layers[0].moe, moe.MoE)
    before = dict(kernels.LAUNCHES)
    res = serve_lm.main(["--arch", arch, "--smoke", "--batch", "2",
                         "--prompt-len", "33", "--gen", "5", "--device",
                         "cpu"])
    assert res.seqs.shape == (2, 5) and res.logits_finite
    assert kernels.LAUNCHES == before


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_moe_apply_matches_cpu(cuda, dtype):
    """One layer of Qwen2-MoE's smoke width, padded experts, on the card
    against the CPU in float32, and in bf16 on the card without a host
    sync (in float32 PyTorch's ``_grouped_mm`` reads the group offsets on
    the host)."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", True),
                              n_experts=6, top_k=2, d_expert=48,
                              compute_dtype=dtype)
    cpu = moe.MoE(cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = moe.MoE(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(4, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(cpu.e_wi.dtype)
    want, waux = moe.moe_apply(cpu, x, cfg)
    xc = x.to(cuda)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error" if dtype == "bfloat16" else 0)
    try:
        got, aux = moe.moe_apply(card, xc, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    if dtype == "float32":
        _close(got, want.numpy(), LAYER_TOL)
    else:
        diff = (got.float().cpu() - want.float()).abs()
        assert float(diff.max()) <= 2 ** -6 * max(1.0, float(
            want.float().abs().max()))
    _close(aux, waux.numpy(), AUX_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_model_matches_cpu(cuda, arch):
    """Float32, the same weights: prefill, then decode teacher-forced on
    the CPU's greedy tokens; one K6 a layer and one K7 a layer and step."""
    cfg = get_config(arch, smoke=True)
    cpu = transformer.init(torch.Generator().manual_seed(0), cfg)
    card = transformer.Transformer(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = api.synth_batch(1, cfg, 2, 77, device="cpu")["tokens"]
    kernels.reset_launches()
    want, cstate = transformer.prefill(cpu, tokens, cfg, max_len=90)
    got, gstate = transformer.prefill(card, tokens.to(cuda), cfg, max_len=90)
    _close(got, want.numpy(), MODEL_TOL)
    for _ in range(5):
        nxt = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        want, cstate = transformer.decode_step(cpu, cstate, nxt, cfg)
        got, gstate = transformer.decode_step(card, gstate, nxt.to(cuda), cfg)
        _close(got, want.numpy(), MODEL_TOL)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "flash_attention": cfg.n_layers, "decode_attention": 5 * cfg.n_layers}


@pytest.mark.gpu
def test_gpu_serve_lm_runs_moe(cuda):
    """``serve_lm`` on the card in bf16 (Qwen3-MoE's smoke widths, whose
    expert width keeps bf16 rows 16-byte aligned): one K6 a layer, one K7 a
    layer and step, and no host sync in the decode loop."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", True),
                              compute_dtype="bfloat16")
    kernels.reset_launches()
    res = serve_lm.serve(cfg, batch=3, prompt_len=100, gen=7)
    assert res.logits_finite and res.seqs.shape == (3, 7)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "flash_attention": cfg.n_layers, "decode_attention": 6 * cfg.n_layers}

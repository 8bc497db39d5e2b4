"""The port's dense-transformer serving path held against the JAX
package's, in float32 on the CPU: the layers, the parameter conversion,
prefill and teacher-forced decode logits, ``synth_batch`` and the
``serve_lm`` driver.

The JAX model runs its own attention defaults here (``ref.attention`` for
prefill, ``grouped_decode_attention`` for decode; hazard H5 in
ROADMAP.md), the port its kernels' plain versions.  Logits must agree
within 1e-4.  Tokens are compared only where the reference's top-2 margin
exceeds that, since a near-tie may flip (hazard H8).  The tests marked
``gpu`` run the same model on the card against the CPU.
"""
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve_lm
from repro_torch.models import (api, convert, encdec, jamba, layers, moe,
                                 rwkv6, transformer)
from repro_torch.train import serve_step

LOGIT_TOL = 1e-4
LAYER_TOL = 1e-5      # one layer's float32 outputs of order 1
ARCHS = ["qwen1.5-0.5b", "qwen2.5-14b"]


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's LM substrate, imported for this module only (the
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
        from repro.models import layers as rlayers
        from repro.train import serve_step as rserve
        yield types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                    api=rapi, layers=rlayers, serve=rserve)
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


def _qk_norm_cfg(ref):
    """A dense smoke model with per-head q/k RMS norms (no dense config of
    the repo has them; Qwen3's MoE does)."""
    rcfg = dataclasses.replace(ref.configs.get_config("qwen1.5-0.5b", True),
                               qk_norm=True)
    return rcfg, dataclasses.replace(get_config("qwen1.5-0.5b", True),
                                     qk_norm=True)


def _reference(ref, arch, seed=0):
    """(JAX config, port config, JAX params, the port's model of them)."""
    if arch == "qk-norm":
        rcfg, cfg = _qk_norm_cfg(ref)
    else:
        rcfg, cfg = ref.configs.get_config(arch, True), get_config(arch, True)
    params = ref.api.get_model(rcfg).init(ref.jax.random.PRNGKey(seed), rcfg)
    model = convert.from_reference(
        ref.jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return rcfg, cfg, params, model


def _np(x):
    return np.asarray(x, np.float32)


def _close(got: torch.Tensor, want, tol) -> float:
    err = float(np.abs(got.detach().float().numpy() - _np(want)).max())
    assert err < tol, err
    return err


# --- configs and conversion --------------------------------------------------

def test_configs_equal_reference(ref):
    assert list_archs() == ref.configs.list_archs()
    for arch in list_archs():
        for smoke in (False, True):
            assert (dataclasses.asdict(get_config(arch, smoke))
                    == dataclasses.asdict(ref.configs.get_config(arch, smoke)))


@pytest.mark.parametrize("arch", ARCHS + ["phi3-mini-3.8b", "qk-norm"])
def test_from_reference_round_trip(ref, arch):
    """Every JAX leaf lands in one port parameter: matrices transposed to
    (out, in), per-layer leaves split off the layer axis; nothing is left
    over on either side."""
    _, cfg, params, model = _reference(ref, arch)
    state = model.state_dict()
    leaves = ref.jax.tree_util.tree_flatten_with_path(params)[0]
    n_port = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        leaf = _np(leaf)
        if keys[0] != "layers":
            got = state[keys[0]].numpy()
            want = leaf.T if keys[0] == "lm_head" else leaf
            assert np.array_equal(got, want), keys
            n_port += 1
            continue
        for i in range(cfg.n_layers):
            got = state[".".join(["layers", str(i)] + keys[1:])].numpy()
            want = leaf[i].T if leaf.ndim == 3 else leaf[i]
            assert np.array_equal(got, want), (keys, i)
            n_port += 1
    assert n_port == len(state)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_from_reference_refuses_missing_or_misshapen(ref):
    _, cfg, params, _ = _reference(ref, "qwen1.5-0.5b")
    params = ref.jax.tree_util.tree_map(np.asarray, params)
    no_bias = dict(params, layers=dict(params["layers"], attn={
        k: v for k, v in params["layers"]["attn"].items() if k != "bq"}))
    with pytest.raises(RuntimeError, match="bq"):
        convert.from_reference(no_bias, cfg, device="cpu")
    narrow = dict(params, final_norm=params["final_norm"][:-1])
    with pytest.raises(RuntimeError, match="final_norm"):
        convert.from_reference(narrow, cfg, device="cpu")


# --- layers ------------------------------------------------------------------

def test_rmsnorm_and_rope_match_reference(ref):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    _close(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma), 1e-6),
           ref.layers.rmsnorm(x, gamma, 1e-6), LAYER_TOL)
    beta = rng.standard_normal(16).astype(np.float32)
    _close(layers.layernorm(torch.from_numpy(x), torch.from_numpy(gamma),
                            torch.from_numpy(beta), 1e-5),
           ref.layers.layernorm(x, gamma, beta, 1e-5), LAYER_TOL)
    for pos in (np.arange(9), rng.integers(0, 64, (2, 9))):
        for theta in (1e4, 1e6):
            _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta),
                   ref.layers.rope(x, pos, theta), LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS + ["qk-norm"])
def test_attn_apply_and_swiglu_match_reference(ref, arch):
    rcfg, cfg, params, model = _reference(ref, arch)
    lp = ref.jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    x = np.random.default_rng(1).standard_normal((2, 13, cfg.d_model))
    x = x.astype(np.float32)
    pos = np.arange(13)
    want, (wk, wv) = ref.layers.attn_apply(lp["attn"], x, rcfg,
                                           positions=pos, return_kv=True)
    got, (gk, gv) = layers.attn_apply(model.layers[0].attn,
                                      torch.from_numpy(x), cfg,
                                      positions=torch.from_numpy(pos),
                                      return_kv=True)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w, LAYER_TOL)
    _close(layers.swiglu_apply(model.layers[0].mlp, torch.from_numpy(x)),
           ref.layers.swiglu_apply(lp["mlp"], x), LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_decode_stacked_matches_reference(ref, arch):
    rcfg, cfg, params, model = _reference(ref, arch)
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 2, cfg.n_kv_heads, 11, cfg.hd)
    ks, vs = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    lp = ref.jax.tree_util.tree_map(lambda a: a[1], params["layers"])
    want, wks, wvs = ref.layers.attn_decode_stacked(lp["attn"], x, rcfg, ks,
                                                    vs, 1, 6)
    tks, tvs = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
    got, gks, gvs = layers.attn_decode_stacked(
        model.layers[1].attn, torch.from_numpy(x), cfg, tks, tvs, 1, 6)
    assert gks is tks and gvs is tvs            # written in place
    for g, w in ((got, want), (gks, wks), (gvs, wvs)):
        _close(g, w, LAYER_TOL)
    with pytest.raises(IndexError, match="full"):
        layers.attn_decode_stacked(model.layers[1].attn, torch.from_numpy(x),
                                   cfg, tks, tvs, 1, 11)


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(ref, arch):
    """Prefill logits, then decode logits teacher-forced on the reference's
    greedy tokens, within 1e-4 at every step."""
    rcfg, cfg, params, model = _reference(ref, arch)
    b, s, gen = 2, 24, 6
    batch = ref.api.synth_batch(3, rcfg, b, s)
    tokens = api.synth_batch(3, cfg, b, s, device="cpu")["tokens"]
    rpre = ref.jax.jit(ref.serve.make_prefill_step(rcfg, max_len=s + gen))
    rdec = ref.jax.jit(ref.serve.make_decode_step(rcfg))
    want, rstate = rpre(params, batch)
    got, state = serve_step.make_prefill_step(cfg, max_len=s + gen)(
        model, {"tokens": tokens})
    assert got.shape == (b, 1, cfg.vocab) and state.index == s
    assert state.k.shape == (cfg.n_layers, b, cfg.n_kv_heads, s + gen, cfg.hd)
    _close(got, want, LOGIT_TOL)
    _close(state.k[:, :, :, :s], rstate.k[:, :, :, :s], LAYER_TOL)
    dec = serve_step.make_decode_step(cfg)
    nxt = ref.jnp.argmax(want[:, -1], -1)[:, None].astype(ref.jnp.int32)
    compared = 0
    for i in range(gen - 1):
        rn, rstate, want = rdec(params, rstate, nxt,
                                ref.jax.random.PRNGKey(i))
        tn, state, got = dec(model, state, torch.from_numpy(np.array(nxt)))
        _close(got, want, LOGIT_TOL)
        top2 = np.sort(_np(want[:, -1]), axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > LOGIT_TOL
        assert np.array_equal(tn.numpy()[sure], np.asarray(rn)[sure])
        compared += int(sure.sum())
        nxt = rn
    assert state.index == s + gen - 1 and compared > 0
    _close(state.v, rstate.v, LAYER_TOL)


def test_synth_batch_matches_reference(ref):
    for arch in ARCHS:
        rcfg, cfg = ref.configs.get_config(arch, True), get_config(arch, True)
        want = ref.api.synth_batch(7, rcfg, 3, 10)
        got = api.synth_batch(7, cfg, 3, 10, device="cpu")
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert np.array_equal(got[key].numpy(), np.asarray(want[key]))


def test_unported_families_raise():
    for arch in list_archs():
        cfg = get_config(arch, smoke=True)
        if cfg.family == "dense":
            model = api.get_model(cfg)
            assert model.init is transformer.init
            state = model.make_decode_state(cfg, 2, 10, device="cpu")
            assert state.k.shape == (cfg.n_layers, 2, cfg.n_kv_heads, 10,
                                     cfg.hd) and state.index == 0
            continue
        if cfg.family == "ssm":        # RWKV6: tests/test_torch_rwkv6.py
            assert api.get_model(cfg).init is rwkv6.init
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                transformer.Transformer(cfg, device="cpu")
            continue
        if cfg.family == "moe":        # tests/test_torch_moe.py
            model = api.get_model(cfg)
            assert model.init is transformer.init
            assert model.decode_step is transformer.decode_step
            assert isinstance(transformer.Transformer(cfg, device="cpu")
                              .layers[0].moe, moe.MoE)
            continue
        if cfg.family == "hybrid":     # Jamba: tests/test_torch_mamba.py
            assert api.get_model(cfg).init is jamba.init
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                transformer.Transformer(cfg, device="cpu")
            continue
        if cfg.family == "vlm":        # InternVL2: tests/test_torch_vlm.py
            model = api.get_model(cfg)
            assert model.init is transformer.init
            assert transformer.Transformer(cfg, device="cpu").patch_proj \
                .shape == (cfg.d_model, cfg.d_frontend)
            continue
        assert cfg.family == "encdec"  # tests/test_torch_encdec.py
        assert api.get_model(cfg).init is encdec.init
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            transformer.Transformer(cfg, device="cpu")
    assert api.WAITING == {}


def test_categorical_sampling_follows_the_softmax():
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    with pytest.raises(ValueError, match="sampler"):
        serve_step.make_decode_step(cfg, sample="top_k")
    probs = torch.tensor([0.2, 0.3, 0.5])
    logits = probs.log().expand(20000, 1, 3)
    draws = serve_step.pick(logits, sample="categorical",
                            generator=torch.Generator().manual_seed(0))
    freq = torch.bincount(draws.long(), minlength=3).float() / draws.numel()
    assert float((freq - probs).abs().max()) < 0.02
    again = serve_step.pick(logits, sample="categorical",
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)
    cold = serve_step.pick(logits, sample="categorical", temperature=1e-3,
                           generator=torch.Generator().manual_seed(0))
    assert bool((cold == 2).all())
    assert bool((serve_step.pick(logits) == 2).all())


# --- the serving driver ------------------------------------------------------

def test_serve_lm_runs_on_the_cpu():
    before = dict(kernels.LAUNCHES)
    res = serve_lm.main(["--arch", "qwen2.5-14b", "--smoke", "--batch", "2",
                         "--prompt-len", "77", "--gen", "5", "--device",
                         "cpu"])
    assert res.seqs.shape == (2, 5) and res.seqs.dtype == torch.int32
    assert res.logits_finite and res.device == "cpu"
    assert kernels.LAUNCHES == before
    again = serve_lm.main(["--arch", "qwen2.5-14b", "--smoke", "--batch",
                           "2", "--prompt-len", "77", "--gen", "5",
                           "--device", "cpu", "--sample", "categorical"])
    assert again.seqs.shape == (2, 5)
    assert torch.equal(again.seqs[:, 0], res.seqs[:, 0])   # prefill argmax


def test_serve_lm_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--smoke", "--gen", "2"])


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_model_matches_cpu(cuda, arch):
    """Float32, the same weights: the card with its kernels, the CPU with
    the plain versions; teacher-forced on the CPU's greedy tokens."""
    cfg = get_config(arch, smoke=True)
    cpu = transformer.init(torch.Generator().manual_seed(0), cfg)
    card = transformer.Transformer(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = api.synth_batch(1, cfg, 2, 77, device="cpu")["tokens"]
    before = dict(kernels.LAUNCHES)
    want, cstate = transformer.prefill(cpu, tokens, cfg, max_len=83)
    got, gstate = transformer.prefill(card, tokens.to(cuda), cfg, max_len=83)
    _close(got.cpu(), want, LOGIT_TOL)
    for _ in range(5):
        nxt = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        want, cstate = transformer.decode_step(cpu, cstate, nxt, cfg)
        got, gstate = transformer.decode_step(card, gstate, nxt.to(cuda), cfg)
        _close(got.cpu(), want, LOGIT_TOL)
    assert kernels.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + cfg.n_layers
    assert kernels.LAUNCHES["decode_attention"] == \
        before["decode_attention"] + 5 * cfg.n_layers


@pytest.mark.gpu
def test_gpu_phi3_matches_cpu_and_serves(cuda):
    """Phi-3's head dims on the card (fault F1): 24 in its smoke config,
    float32 against the CPU, then ``serve_lm`` in bf16 at head dim 96 with
    the smoke config's other widths."""
    cfg = get_config("phi3-mini-3.8b", smoke=True)
    assert cfg.hd == 24
    cpu = transformer.init(torch.Generator().manual_seed(0), cfg)
    card = transformer.Transformer(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = api.synth_batch(2, cfg, 2, 50, device="cpu")["tokens"]
    kernels.reset_launches()
    want, cstate = transformer.prefill(cpu, tokens, cfg, max_len=54)
    got, gstate = transformer.prefill(card, tokens.to(cuda), cfg, max_len=54)
    _close(got.cpu(), want, LOGIT_TOL)
    for _ in range(3):
        nxt = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        want, cstate = transformer.decode_step(cpu, cstate, nxt, cfg)
        got, gstate = transformer.decode_step(card, gstate, nxt.to(cuda), cfg)
        _close(got.cpu(), want, LOGIT_TOL)
    assert kernels.LAUNCHES["flash_attention"] == cfg.n_layers
    assert kernels.LAUNCHES["decode_attention"] == 3 * cfg.n_layers
    wide = dataclasses.replace(cfg, d_model=384, compute_dtype="bfloat16")
    assert wide.hd == 96
    kernels.reset_launches()
    res = serve_lm.serve(wide, batch=2, prompt_len=70, gen=4)
    assert res.logits_finite and res.seqs.shape == (2, 4)
    assert kernels.LAUNCHES["flash_attention"] == wide.n_layers
    assert kernels.LAUNCHES["decode_attention"] == 3 * wide.n_layers


@pytest.mark.gpu
def test_gpu_serve_lm_launches_the_kernels_without_host_syncs(cuda):
    """The decode loop runs under sync debug mode "error" on the card."""
    kernels.reset_launches()
    res = serve_lm.main(["--smoke", "--batch", "3", "--prompt-len", "100",
                         "--gen", "7", "--sample", "categorical"])
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    assert res.logits_finite and res.seqs.shape == (3, 7)
    assert kernels.LAUNCHES["flash_attention"] == cfg.n_layers
    assert kernels.LAUNCHES["decode_attention"] == 6 * cfg.n_layers

"""The port's VLM family (InternVL2-2B) held against the JAX package's, in
float32 on the CPU: ``synth_batch``, the parameter conversion, the loss
and every gradient under remat ``none`` and ``full`` at 1,032 positions
(1,024 tokens after 8 patches), prefill and teacher-forced decode logits,
the ``make_prefill_step`` contract, a train step with gradient
accumulation, and the attention's training path past 1,024 positions.

Past 1,024 positions the JAX package differentiates ``chunked_attention``
(S < 2,048) and ``blocked_attention``; the port runs the plain forward and
``backward.py`` in query blocks.  Tolerances as in
``tests/test_torch_encdec.py``; the attention's output and gradients
within 1e-4 × max(1, max |x|).  The tests marked ``gpu`` run the blocked
backward and the model on the card.
"""
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.models import api, convert, transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import serve_step
from repro_torch.train.train_step import TrainHParams, make_train_step

ARCH = "internvl2-2b"
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
LAYER_TOL = 1e-5
ATTN_TOL = 1e-4
BATCH, SEQ = 1, 1024          # 1,032 positions with the 8 patches


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's models, imported for this module only (the
    ``jax.experimental.enable_x64`` name is installed for the import and
    removed again with the ``repro`` modules on teardown; hazard H1).
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
        from repro.kernels.flash_attention import ops as rops
        from repro.models import api as rapi
        from repro.train import serve_step as rserve
        from repro.train import train_step as rtrain
        rcfg = configs.get_config(ARCH, True)
        params = rapi.get_model(rcfg).init(jax.random.PRNGKey(0), rcfg)
        yield types.SimpleNamespace(
            jax=jax, jnp=jnp, api=rapi, serve=rserve, train=rtrain,
            ops=rops, rcfg=rcfg, params=params,
            np_params=jax.tree_util.tree_map(
                lambda x: np.asarray(x, np.float32), params),
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
    return torch.device("cuda")


def _cfg():
    return get_config(ARCH, True)


def _tensors(batch, device="cpu"):
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def _close(got: torch.Tensor, want, tol) -> float:
    err = float(np.abs(got.detach().float().cpu().numpy()
                       - np.asarray(want, np.float32)).max())
    assert err < tol, err
    return err


def _scaled_close(got: torch.Tensor, want, tol) -> None:
    want = np.asarray(want, np.float32)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _assert_tree_close(got, want, tol, path=()):
    """Each leaf within ``tol`` × max(1, max |want|) of that leaf."""
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_tree_close(got[k], w, tol, path + (k,))
            continue
        g, w = np.asarray(got[k], np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, path + (k,)
        lim = tol * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= lim, path + (k,)


# --- batches and conversion ---------------------------------------------------

def test_synth_batch_matches_reference(ref):
    """tokens, labels and patch_embeds (B, P, d_frontend) equal the JAX
    package's for one seed."""
    want = ref.api.synth_batch(7, ref.rcfg, 3, 10)
    got = api.synth_batch(7, _cfg(), 3, 10, device="cpu")
    assert sorted(got) == sorted(want) == ["labels", "patch_embeds",
                                           "tokens"]
    assert tuple(got["patch_embeds"].shape) == (3, 8, 32)
    for key, w in want.items():
        assert str(got[key].dtype).split(".")[1] == str(w.dtype), key
        assert np.array_equal(got[key].numpy(), np.asarray(w)), key


def test_convert_round_trip(ref):
    """``patch_proj`` lands transposed beside the layers, and
    ``to_reference`` gives the pytree back."""
    cfg = _cfg()
    model = convert.from_reference(ref.np_params, cfg, device="cpu")
    assert isinstance(model, transformer.Transformer)
    state = model.state_dict()
    assert np.array_equal(state["patch_proj"].numpy(),
                          ref.np_params["patch_proj"].T)
    back = convert.to_reference(state, cfg)
    _assert_tree_close(back, ref.np_params, 0.0)
    again = convert.from_reference(back, cfg, device="cpu").state_dict()
    for name, t in state.items():
        assert torch.equal(again[name], t), name


# --- the loss and its gradients ----------------------------------------------

def _jax_grads(ref, remat):
    if remat not in ref.cache:
        model = ref.api.get_model(ref.rcfg)
        batch = {k: np.asarray(v) for k, v in
                 ref.api.synth_batch(0, ref.rcfg, BATCH, SEQ).items()}
        loss, grads = ref.jax.jit(ref.jax.value_and_grad(
            lambda p, b: model.loss_fn(p, b, ref.rcfg, remat=remat)))(
                ref.params, batch)
        ref.cache[remat] = (batch, float(loss), ref.jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), grads))
    return ref.cache[remat]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_reference(ref, monkeypatch, remat):
    """At 1,032 positions the JAX model differentiates
    ``chunked_attention`` and the port its blocked backward: the loss over
    the token positions and every gradient leaf, ``patch_proj``'s
    included, equal ``jax.value_and_grad`` under the same remat; the
    backward takes 344-row query blocks."""
    cfg = _cfg()
    batch, want_loss, want_grads = _jax_grads(ref, remat)
    model = convert.from_reference(ref.np_params, cfg, device="cpu",
                                   train=True)
    chunks = []
    orig = attn_ops.attention_backward
    monkeypatch.setattr(attn_ops, "attention_backward", lambda *a, **kw: (
        chunks.append(kw["q_chunk"]), orig(*a, **kw))[1])
    names, leaves = zip(*model.named_parameters())
    loss = transformer.loss_fn(model, _tensors(batch), cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    assert chunks == [344] * cfg.n_layers
    assert abs(float(loss.detach()) - want_loss) <= \
        LOSS_RTOL * abs(want_loss)
    _assert_tree_close(convert.to_reference(dict(zip(names, grads)), cfg),
                       want_grads, GRAD_TOL)


def test_train_step_with_accumulation_matches_reference(ref):
    """One AdamW step at grad_accum 2: each microbatch takes its rows of
    the patch embeddings with its tokens; the loss and the gradient norm
    equal the JAX step's."""
    cfg = _cfg()
    batch = {k: np.asarray(v) for k, v in
             ref.api.synth_batch(4, ref.rcfg, 4, 32).items()}
    hp = dict(remat="full", grad_accum=2)
    s0 = ref.train.init_train_state(ref.jax.random.PRNGKey(0), ref.rcfg)
    model = convert.from_reference(
        ref.jax.tree_util.tree_map(np.asarray, s0["params"]), cfg,
        device="cpu", train=True)
    _, rm = ref.train.make_train_step(
        ref.rcfg, ref.train.TrainHParams(**hp))(s0, batch)
    state = dict(params=model, opt=opt.init(dict(model.named_parameters())))
    state, m = make_train_step(cfg, TrainHParams(**hp))(state,
                                                        _tensors(batch))
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(rm[key])) <= \
            LOSS_RTOL * abs(float(rm[key])), key
    assert int(state["opt"]["step"]) == 1


# --- serving -------------------------------------------------------------------

def test_prefill_and_decode_logits_match_reference(ref):
    """Prefill over the 8 patches and 24 tokens, then four decode steps
    teacher-forced on the reference's greedy tokens, within the
    tolerances; the cache holds max_len + 8 positions."""
    cfg, s, gen = _cfg(), 24, 5
    p = cfg.n_frontend_tokens
    batch = {k: np.asarray(v) for k, v in
             ref.api.synth_batch(3, ref.rcfg, 2, s).items() if k != "labels"}
    model = convert.from_reference(ref.np_params, cfg, device="cpu")
    rpre = ref.jax.jit(ref.serve.make_prefill_step(ref.rcfg, max_len=s + gen))
    rdec = ref.jax.jit(ref.serve.make_decode_step(ref.rcfg))
    want, rstate = rpre(ref.params, batch)
    got, state = serve_step.make_prefill_step(cfg, max_len=s + gen)(
        model, _tensors(batch))
    assert state.index == p + s
    assert state.k.shape == (cfg.n_layers, 2, cfg.n_kv_heads, p + s + gen,
                             cfg.hd)
    _close(got, want, LOGIT_TOL)
    _close(state.k[:, :, :, :p + s], rstate.k[:, :, :, :p + s], LAYER_TOL)
    dec = serve_step.make_decode_step(cfg)
    nxt = ref.jnp.argmax(want[:, -1], -1)[:, None].astype(ref.jnp.int32)
    for i in range(gen - 1):
        rn, rstate, want = rdec(ref.params, rstate, nxt,
                                ref.jax.random.PRNGKey(i))
        _, state, got = dec(model, state, torch.from_numpy(np.array(nxt)))
        _close(got, want, LOGIT_TOL)
        nxt = rn
    assert state.index == p + s + gen - 1
    _close(state.v, rstate.v, LAYER_TOL)


def test_prefill_step_contract():
    """``make_prefill_step`` gives exactly (logits, state), the state the
    KV cache that ``make_decode_step`` takes and gives back."""
    cfg = _cfg()
    model = transformer.init(torch.Generator().manual_seed(0), cfg)
    batch = api.synth_batch(2, cfg, 2, 16, device="cpu")
    out = serve_step.make_prefill_step(cfg, max_len=24)(model, batch)
    assert isinstance(out, tuple) and len(out) == 2
    logits, state = out
    assert state.index == 16 + cfg.n_frontend_tokens
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    _, state2, _ = serve_step.make_decode_step(cfg)(model, state, nxt)
    assert type(state2) is type(state) and state2.index == state.index + 1


# --- the attention past 1,024 positions ----------------------------------------

def _attention_inputs(s, causal):
    rng = np.random.default_rng(s + causal)
    shapes = ((1, 4, s, 16), (1, 2, s, 16), (1, 2, s, 16), (1, 4, s, 16))
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1280, 2048])
def test_long_attention_matches_reference(ref, s, causal):
    """B 1, Hq 4 over Hkv 2, D 16, float32: the output and dQ, dK, dV of
    the port's ``attention`` against ``jax.vjp`` of JAX's
    ``ops.attention``, which takes ``chunked_attention`` at 1,280 and
    ``blocked_attention`` at 2,048."""
    q, k, v, do = _attention_inputs(s, causal)
    want, vjp = ref.jax.vjp(
        lambda a, b, c: ref.ops.attention(a, b, c, causal=causal), q, k, v)
    wants = vjp(do)
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = attn_ops.attention(*args, causal=causal)
    grads = torch.autograd.grad(got, args, torch.from_numpy(do))
    _scaled_close(got, want, ATTN_TOL)
    for g, w in zip(grads, wants):
        _scaled_close(g, w, ATTN_TOL)


def test_pick_chunk():
    assert attn_ops._pick_chunk(1280, 512) == 320
    assert attn_ops._pick_chunk(1032, 512) == 344
    assert attn_ops._pick_chunk(4352, 512) == 272
    assert attn_ops._pick_chunk(300, 512) == 300


# --- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1280, 2048])
def test_gpu_blocked_backward_matches_plain_autograd(cuda, dtype, s):
    """InternVL2's head shape (16 over 8 heads, hd 128), batch 1: K6 and
    the blocked backward against autograd through the plain version on
    the card, float32 within 1e-4 × max |g|, bf16 within 2⁻⁶ × max |g|."""
    g = torch.Generator(device=cuda).manual_seed(s)
    shapes = ((1, 16, s, 128), (1, 8, s, 128), (1, 8, s, 128))
    q, k, v = (torch.randn(sh, generator=g, device=cuda).to(dtype)
               .requires_grad_() for sh in shapes)
    do = torch.randn(shapes[0], generator=g, device=cuda).to(dtype)
    kernels.reset_launches()
    got = torch.autograd.grad(attn_ops.attention(q, k, v), (q, k, v), do)
    assert kernels.LAUNCHES["flash_attention"] == 1
    want = torch.autograd.grad(attn_ref.attention(q, k, v), (q, k, v), do)
    rel = 1e-4 if dtype == torch.float32 else 2 ** -6
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert float((a.float() - b.float()).abs().max()) <= rel * float(
            b.float().abs().max())


@pytest.mark.gpu
def test_gpu_model_matches_cpu(cuda):
    """Float32, the same weights: prefill over the patches and three decode
    steps on the card within 1e-4 of the CPU's logits; K6 once a layer in
    the prefill, K7 once a layer a step."""
    cfg = _cfg()
    cpu = transformer.init(torch.Generator().manual_seed(0), cfg)
    card = transformer.Transformer(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = api.synth_batch(1, cfg, 2, 40, device="cpu")
    pre = serve_step.make_prefill_step(cfg, max_len=44)
    dec = serve_step.make_decode_step(cfg)
    kernels.reset_launches()
    want, cstate = pre(cpu, batch)
    got, gstate = pre(card, {k: v.to(cuda) for k, v in batch.items()})
    _close(got, want, LOGIT_TOL)
    for _ in range(3):
        nxt = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        _, cstate, want = dec(cpu, cstate, nxt)
        _, gstate, got = dec(card, gstate, nxt.to(cuda))
        _close(got, want, LOGIT_TOL)
    assert kernels.LAUNCHES["flash_attention"] == cfg.n_layers
    assert kernels.LAUNCHES["decode_attention"] == 3 * cfg.n_layers

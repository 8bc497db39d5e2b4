"""The port's encoder–decoder family (SeamlessM4T-large v2) held against the
JAX package's, in float32 on the CPU: ``synth_batch``, the parameter
conversion, the loss and every gradient under remat ``none`` and
``full`` (and with an encoder length of its own), prefill and
teacher-forced decode logits (with an encoder length of its own), the
``make_prefill_step`` contract, a train step with gradient accumulation,
and K6's key length of its own, forward and backward.

The JAX model runs ``ref.attention`` and ``grouped_decode_attention``
(hazard H5 in ROADMAP.md), the port its kernels' plain versions.
Tolerances: the loss within 1e-5 relative, each gradient leaf within
1e-4 × max(1, max |g|) (``tests/test_torch_train.py``), logits within
1e-4 and one layer's outputs within 1e-5 (``tests/test_torch_lm.py``).
The tests marked ``gpu`` run K6 and the attention Function at
cross-attention lengths and the model on the card.
"""
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.flash_attention.backward import attention_backward
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models import api, convert, encdec, layers
from repro_torch.train import optimizer as opt
from repro_torch.train import serve_step
from repro_torch.train.train_step import TrainHParams, make_train_step

ARCH = "seamless-m4t-large-v2"
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
LAYER_TOL = 1e-5
BATCH, SEQ = 1, 1024          # two chunks of the chunked loss


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
        from repro.kernels.flash_attention import ref as rattn
        from repro.models import api as rapi
        from repro.train import serve_step as rserve
        from repro.train import train_step as rtrain
        rcfg = configs.get_config(ARCH, True)
        params = rapi.get_model(rcfg).init(jax.random.PRNGKey(0), rcfg)
        yield types.SimpleNamespace(
            jax=jax, jnp=jnp, api=rapi, serve=rserve, train=rtrain,
            attn=rattn, ops=rops, rcfg=rcfg, params=params,
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
    """tokens, labels and frame_embeds (B, S, d_frontend) equal the JAX
    package's for one seed."""
    want = ref.api.synth_batch(7, ref.rcfg, 3, 10)
    got = api.synth_batch(7, _cfg(), 3, 10, device="cpu")
    assert sorted(got) == sorted(want) == ["frame_embeds", "labels",
                                           "tokens"]
    for key, w in want.items():
        assert str(got[key].dtype).split(".")[1] == str(w.dtype), key
        assert np.array_equal(got[key].numpy(), np.asarray(w)), key


def test_convert_round_trip(ref):
    """Every leaf of both stacks lands in one port parameter, transposed
    where it is a matrix, and ``to_reference`` gives the pytree back."""
    cfg = _cfg()
    model = convert.from_reference(ref.np_params, cfg, device="cpu")
    assert isinstance(model, encdec.EncDec)
    assert len(model.enc_layers) == cfg.n_enc_layers
    assert len(model.dec_layers) == cfg.n_layers
    state = model.state_dict()
    assert np.array_equal(state["frame_proj"].numpy(),
                          ref.np_params["frame_proj"].T)
    assert np.array_equal(state["dec_layers.1.xattn.wk"].numpy(),
                          ref.np_params["dec_layers"]["xattn"]["wk"][1].T)
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
    """The chunked loss and every gradient leaf of both stacks, the frame
    projection and the head equal ``jax.value_and_grad`` of the JAX
    ``loss_fn`` under the same remat; the attention runs once a layer and
    a stack (twice under ``full``: the recompute)."""
    cfg = _cfg()
    batch, want_loss, want_grads = _jax_grads(ref, remat)
    model = convert.from_reference(ref.np_params, cfg, device="cpu",
                                   train=True)
    calls = []
    orig = attn_ops.flash_attention
    monkeypatch.setattr(attn_ops, "flash_attention", lambda *a, **kw: (
        calls.append(1), orig(*a, **kw))[1])
    names, leaves = zip(*model.named_parameters())
    loss = encdec.loss_fn(model, _tensors(batch), cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    per = cfg.n_enc_layers + 2 * cfg.n_layers
    assert len(calls) == per * (2 if remat == "full" else 1)
    assert abs(float(loss.detach()) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_tree_close(convert.to_reference(dict(zip(names, grads)), cfg),
                       want_grads, GRAD_TOL)


def test_loss_and_gradients_with_own_frame_length_match_reference(ref):
    """S_enc = 24 frames under S_dec = 16 tokens, remat ``none``: the loss
    and every gradient leaf against ``jax.value_and_grad``, so the
    cross-attention's backward runs with a key length of its own."""
    cfg = _cfg()
    batch = _serve_batch(ref, 24, 16)
    batch["labels"] = np.asarray(
        ref.api.synth_batch(3, ref.rcfg, 2, 16)["labels"])
    model = ref.api.get_model(ref.rcfg)
    want_loss, want_grads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: model.loss_fn(p, b, ref.rcfg)))(ref.params, batch)
    port = convert.from_reference(ref.np_params, cfg, device="cpu",
                                  train=True)
    names, leaves = zip(*port.named_parameters())
    loss = encdec.loss_fn(port, _tensors(batch), cfg)
    grads = torch.autograd.grad(loss, leaves)
    want_loss = float(want_loss)
    assert abs(float(loss.detach()) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_tree_close(convert.to_reference(dict(zip(names, grads)), cfg),
                       ref.jax.tree_util.tree_map(
                           lambda x: np.asarray(x, np.float32), want_grads),
                       GRAD_TOL)


def test_train_step_with_accumulation_matches_reference(ref):
    """One AdamW step at grad_accum 2: each microbatch takes its rows of
    the frame embeddings with its tokens, as the JAX step's split does;
    the loss and the gradient norm equal the JAX step's."""
    cfg = _cfg()
    batch = {k: np.asarray(v) for k, v in
             ref.api.synth_batch(4, ref.rcfg, 4, 32).items()}
    hp = dict(remat="none", grad_accum=2)
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

def _serve_batch(ref, s_enc, s_dec):
    """tokens (B, s_dec) and frame_embeds (B, s_enc, d_frontend) of the JAX
    package's draws, as numpy arrays."""
    toks = ref.api.synth_batch(3, ref.rcfg, 2, s_dec)
    frames = ref.api.synth_batch(3, ref.rcfg, 2, s_enc)
    return dict(tokens=np.asarray(toks["tokens"]),
                frame_embeds=np.asarray(frames["frame_embeds"]))


@pytest.mark.parametrize("s_enc", [16, 24])
def test_prefill_and_decode_logits_match_reference(ref, s_enc):
    """Prefill logits, the self cache and the cross K/V, then four decode
    steps teacher-forced on the reference's greedy tokens, within the
    tolerances, with S_dec = 16 and S_enc = 16 or 24."""
    cfg, s, gen = _cfg(), 16, 5
    batch = _serve_batch(ref, s_enc, s)
    model = convert.from_reference(ref.np_params, cfg, device="cpu")
    rpre = ref.jax.jit(ref.serve.make_prefill_step(ref.rcfg, max_len=s + gen))
    rdec = ref.jax.jit(ref.serve.make_decode_step(ref.rcfg))
    want, (rcache, rcross) = rpre(ref.params, batch)
    got, (cache, cross) = serve_step.make_prefill_step(cfg, max_len=s + gen)(
        model, _tensors(batch))
    assert got.shape == (2, 1, cfg.vocab) and cache.index == s
    assert cross[0].shape == (cfg.n_layers, 2, cfg.n_kv_heads, s_enc, cfg.hd)
    _close(got, want, LOGIT_TOL)
    _close(cache.k[:, :, :, :s], rcache.k[:, :, :, :s], LAYER_TOL)
    for g, w in zip(cross, rcross):
        _close(g, w, LAYER_TOL)
    dec = serve_step.make_decode_step(cfg)
    nxt = ref.jnp.argmax(want[:, -1], -1)[:, None].astype(ref.jnp.int32)
    state, rstate = (cache, cross), (rcache, rcross)
    for i in range(gen - 1):
        rn, rstate, want = rdec(ref.params, rstate, nxt,
                                ref.jax.random.PRNGKey(i))
        _, state, got = dec(model, state, torch.from_numpy(np.array(nxt)))
        _close(got, want, LOGIT_TOL)
        nxt = rn
    assert state[0].index == s + gen - 1 and state[1] is cross
    _close(state[0].v, rstate[0].v, LAYER_TOL)


def test_prefill_step_contract(ref):
    """``make_prefill_step`` gives exactly (logits, state), the state the
    (cache, cross) pair that ``make_decode_step`` takes and gives back in
    the same structure (``tests/test_models.py``'s contract); the decode
    state's shapes equal the JAX package's ``make_decode_state``."""
    cfg = _cfg()
    model = encdec.init(torch.Generator().manual_seed(0), cfg)
    batch = api.synth_batch(2, cfg, 2, 16, device="cpu")
    out = serve_step.make_prefill_step(cfg, max_len=24)(model, batch)
    assert isinstance(out, tuple) and len(out) == 2
    logits, state = out
    assert isinstance(state, tuple) and len(state) == 2
    cache, cross = state
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    _, state2, _ = serve_step.make_decode_step(cfg)(model, state, nxt)
    assert isinstance(state2, tuple) and len(state2) == 2
    assert type(state2[0]) is type(cache) and state2[1] is cross
    assert state2[0].index == 17
    want = ref.api.get_model(ref.rcfg).make_decode_state(ref.rcfg, 2, 24)
    got = api.get_model(cfg).make_decode_state(cfg, 2, 24, device="cpu")
    assert tuple(got[0].k.shape) == tuple(want[0].k.shape)
    assert [tuple(t.shape) for t in got[1]] == \
        [tuple(t.shape) for t in want[1]]


def test_attn_decode_matches_reference(ref):
    """Both branches of ``layers.attn_decode`` against the JAX package's:
    one layer's (B, Hkv, S, hd) cache written at its index in place, and
    the cross branch over cached (B, Hkv, S_enc, hd) K/V."""
    import jax
    from repro.models import layers as rlayers
    cfg = _cfg()
    model = convert.from_reference(ref.np_params, cfg, device="cpu")
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((2, cfg.n_kv_heads, 11, cfg.hd))
            .astype(np.float32) for _ in "kv")
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[1], ref.params["dec_layers"])
    rcache = rlayers.KVCache(k=k, v=v, index=ref.jnp.asarray(6, ref.jnp.int32))
    want, wcache = rlayers.attn_decode(lp["attn"], x, ref.rcfg, rcache)
    cache = layers.KVCache(k=torch.from_numpy(k.copy()),
                           v=torch.from_numpy(v.copy()), index=6)
    got, gcache = layers.attn_decode(model.dec_layers[1].attn,
                                     torch.from_numpy(x), cfg, cache)
    assert gcache.k is cache.k and gcache.index == 7
    for g, w in ((got, want), (gcache.k, wcache.k), (gcache.v, wcache.v)):
        _close(g, w, LAYER_TOL)
    want, _ = rlayers.attn_decode(lp["xattn"], x, ref.rcfg, None,
                                  cross_kv=(k, v))
    got, same = layers.attn_decode(model.dec_layers[1].xattn,
                                   torch.from_numpy(x), cfg, None,
                                   cross_kv=(torch.from_numpy(k),
                                             torch.from_numpy(v)))
    assert same is None
    _close(got, want, LAYER_TOL)
    with pytest.raises(IndexError, match="full"):
        layers.attn_decode(model.dec_layers[1].attn, torch.from_numpy(x),
                           cfg, layers.KVCache(k=cache.k, v=cache.v,
                                               index=11))


# --- K6 with a key length of its own -------------------------------------------

@pytest.mark.parametrize("skv", [7, 40, 100])
def test_plain_attention_with_its_own_key_length(ref, skv):
    """The plain K6, non-causal, q (1, 4, 33, 16) over k, v (1, 2, skv, 16),
    against the JAX ``ref.attention``."""
    rng = np.random.default_rng(skv)
    q = rng.standard_normal((1, 4, 33, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, skv, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, skv, 16)).astype(np.float32)
    want = ref.attn.attention(q, k, v, causal=False)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    _close(got, want, LAYER_TOL)


def test_causal_call_with_its_own_key_length_raises():
    q = torch.randn(1, 2, 8, 8)
    k = torch.randn(1, 2, 9, 8)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="causal"):
        attn_ops.attention(q.requires_grad_(), k, k, causal=True)


def _scaled_close(got: torch.Tensor, want, tol) -> None:
    want = np.asarray(want, np.float32)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("q_chunk", [None, 8])
@pytest.mark.parametrize("skv", [7, 40])
def test_attention_backward_with_its_own_key_length(skv, q_chunk):
    """dQ, dK and dV of ``backward.attention_backward``, non-causal, q
    (1, 4, 32, 16) over k, v (1, 2, skv, 16), whole or in query blocks of
    8, against autograd through the plain ``ref.attention``, within 1e-4
    × max(1, max |g|) (JAX's gradients at such shapes:
    ``test_long_cross_attention_matches_reference``)."""
    rng = np.random.default_rng(skv)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, 32, 16))
                              .astype(np.float32)) for _ in "qo")
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, skv, 16))
                             .astype(np.float32)).requires_grad_()
            for _ in "kv")
    q.requires_grad_()
    o = attn_ref.attention(q, k, v, causal=False)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = attention_backward(q.detach(), k.detach(), v.detach(), o.detach(),
                             do, causal=False, q_chunk=q_chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _scaled_close(g, w.numpy(), GRAD_TOL)


@pytest.mark.parametrize("s,skv", [(1280, 777)])
def test_long_cross_attention_matches_reference(ref, s, skv):
    """B 1, Hq 4 over Hkv 2, D 16, float32, non-causal: the output and
    dQ, dK, dV of the port's ``attention`` (its backward in query blocks
    of 320 rows) against ``jax.vjp`` of JAX's ``ops.attention``
    (``chunked_attention`` over key chunks of 259), S_kv keys apart from
    the S rows."""
    rng = np.random.default_rng(s + skv)
    q, do = (rng.standard_normal((1, 4, s, 16)).astype(np.float32)
             for _ in "qo")
    k, v = (rng.standard_normal((1, 2, skv, 16)).astype(np.float32)
            for _ in "kv")
    want, vjp = ref.jax.vjp(
        lambda a, b, c: ref.ops.attention(a, b, c, causal=False), q, k, v)
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = attn_ops.attention(*args, causal=False)
    grads = torch.autograd.grad(got, args, torch.from_numpy(do))
    _scaled_close(got, want, GRAD_TOL)
    for g, w in zip(grads, vjp(do)):
        _scaled_close(g, w, GRAD_TOL)


# --- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skv", [777, 1536])
def test_gpu_flash_attention_cross_lengths(cuda, dtype, skv):
    """K6 non-causal at SeamlessM4T's head shape (16 heads, hd 64), S_q
    1024 over S_kv keys (777 leaves a partial tile), against its plain
    version: float32 within 1e-4 × max(1, max |o|), bf16 within two bf16
    ulps of each output plus 1e-5; launched once."""
    g = torch.Generator(device=cuda).manual_seed(skv)
    q = torch.randn(2, 16, 1024, 64, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, 16, skv, 64, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, 16, skv, 64, generator=g, device=cuda).to(dtype)
    kernels.reset_launches()
    got = fa.flash_attention(q, k, v, causal=False)
    assert kernels.LAUNCHES["flash_attention"] == 1
    want = fa.flash_attention_plain(q, k, v, causal=False)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= 2 ** -6 * want.float().abs() + 1e-5).all())
    else:
        assert float(diff.max()) <= 1e-4 * max(
            1.0, float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1024, 1280])
def test_gpu_attention_function_cross_length(cuda, dtype, s):
    """The attention Function at SeamlessM4T's head shape (16 heads, hd
    64), batch 2, non-causal, S rows over 777 keys (at 1,280 rows the
    backward runs in query blocks): K6 once, and the output and dQ, dK, dV
    against autograd through the plain version on the card, float32
    within 1e-4 × max |x|, bf16 within 2⁻⁶ × max |x|."""
    g = torch.Generator(device=cuda).manual_seed(s)
    shapes = ((2, 16, s, 64), (2, 16, 777, 64), (2, 16, 777, 64))
    q, k, v = (torch.randn(sh, generator=g, device=cuda).to(dtype)
               .requires_grad_() for sh in shapes)
    do = torch.randn(shapes[0], generator=g, device=cuda).to(dtype)
    kernels.reset_launches()
    out = attn_ops.attention(q, k, v, causal=False)
    got = (out,) + torch.autograd.grad(out, (q, k, v), do)
    assert kernels.LAUNCHES["flash_attention"] == 1
    ref_out = attn_ref.attention(q, k, v, causal=False)
    want = (ref_out,) + torch.autograd.grad(ref_out, (q, k, v), do)
    rel = 1e-4 if dtype == torch.float32 else 2 ** -6
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        a, b = a.detach().float(), b.detach().float()
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.mark.gpu
def test_gpu_model_matches_cpu(cuda):
    """Float32, the same weights, S_enc 40 and S_dec 24: prefill and three
    decode steps on the card within 1e-4 of the CPU's logits; K6 once a
    layer and stack in the prefill, K7 twice a decoder layer a step."""
    cfg = _cfg()
    cpu = encdec.init(torch.Generator().manual_seed(0), cfg)
    card = encdec.EncDec(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = dict(tokens=api.synth_batch(1, cfg, 2, 24, device="cpu")[
        "tokens"], frame_embeds=api.synth_batch(1, cfg, 2, 40, device="cpu")[
        "frame_embeds"])
    pre = serve_step.make_prefill_step(cfg, max_len=28)
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
    assert kernels.LAUNCHES["flash_attention"] == \
        cfg.n_enc_layers + 2 * cfg.n_layers
    assert kernels.LAUNCHES["decode_attention"] == 3 * 2 * cfg.n_layers

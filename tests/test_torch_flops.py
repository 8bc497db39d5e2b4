"""The port's FLOP and byte counter (``launch/flops.py``) held against the
JAX package's jaxpr counter (``repro/launch/flops.py``), and backend
pinning (``platform.py``), on the CPU.

Every check is an exact integer equality:

* the per-op rules against hand counts (products, views, data movement,
  every other op);
* each kernel's charge: the counter's whole count of a kernel call is its
  charge, by the one rule (inputs and outputs once; output elements plus
  matmul FLOPs), and the charge's matmul FLOPs are the dot FLOPs that the
  JAX counter finds in ``repro/kernels/<k>/ref.py`` at the same shapes;
* the models: the port's matmul FLOPs are the JAX counter's dot FLOPs
  plus terms written out below, each with its reason.  The JAX side is
  counted with ``ELEMENTWISE_FREE`` replaced by a container that holds
  every primitive (pytest's ``monkeypatch``), which leaves the products
  alone: ``dot_general`` and ``conv_general_dilated``.

The terms by which the port differs from the reference, each a finding
(ROADMAP hazards H18 and H20):

* every attention backward recomputes its logits (``backward.py:64``):
  2·B·Hq·S·S_kv·hd, where JAX keeps them from its forward;
* the MoE expert products: jax 0.9.0 traces ``ragged_dot`` as
  ``ragged_dot_general``, which the JAX counter does not match
  (``flops.py:112``; H18), so it counts them as no product; the port
  counts 2·T·k·D·F for each grouped product, forward and backward;
* the Jamba reference's Mamba conv is a ``conv_general_dilated`` (2·B·T·
  d_inner·d_conv a layer), the port's K shifted multiply-adds; and the
  reference's stateful ``mamba_apply`` computes ``in_proj`` twice in its
  prefill (2·B·T·d·2·d_inner more a layer);
* the SeamlessM4T reference's prefill computes the cross-attention's K and
  V twice (once to cache, once inside ``attn_apply``): 2·2·B·S_enc·d·kv
  more a decoder layer.

The ``gpu`` cases hold phase 11a of ``chip_smoke.py`` on two archs (card
against CPU) and ``pin("gpu")`` in a fresh process.
"""
import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import repro_torch
from repro_torch import kernels, platform
from repro_torch.configs import get_config, list_archs
from repro_torch.core import generators, mst_api
from repro_torch.kernels.decode_attention import decode_attention as k7
from repro_torch.kernels.edge_hash import edge_hash as k5
from repro_torch.kernels.edge_hash import ops as hash_ops
from repro_torch.kernels.flash_attention import flash_attention as k6
from repro_torch.kernels.mamba_scan import mamba_scan as k8
from repro_torch.kernels.rwkv6 import wkv6 as k9
from repro_torch.kernels.segment_min import segment_min as k14
from repro_torch.kernels.spmv_minplus import spmv_minplus as k23
from repro_torch.launch import flops
from repro_torch.models import api
from repro_torch.train import serve_step
from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                          make_train_step)

ROOT = Path(repro_torch.__file__).resolve().parents[2]
B, S, GEN = 2, 32, 2
TRAINED = ("qwen1.5-0.5b", "qwen2.5-14b", "qwen2.5-32b", "phi3-mini-3.8b",
           "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "internvl2-2b",
           "seamless-m4t-large-v2")


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's counter, models, steps and kernel references,
    imported for this module only (the ``jax.experimental.enable_x64`` name
    is installed for the import and removed again with the ``repro``
    modules on teardown; hazard H1).  ``cache`` holds each JAX count once
    for the module."""
    import jax
    import jax.experimental
    import jax.numpy as jnp
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro import configs
        from repro.kernels.decode_attention import ref as r7
        from repro.kernels.edge_hash import ref as r5
        from repro.kernels.flash_attention import ref as r6
        from repro.kernels.mamba_scan import ref as r8
        from repro.kernels.rwkv6 import ref as r9
        from repro.kernels.segment_min import ref as r14
        from repro.kernels.spmv_minplus import ref as r23
        from repro.launch import flops as rflops
        from repro.models import api as rapi
        from repro.train import serve_step as rserve
        from repro.train import train_step as rtrain
        yield types.SimpleNamespace(
            jax=jax, jnp=jnp, configs=configs, flops=rflops, api=rapi,
            serve=rserve, train=rtrain, r5=r5, r6=r6, r7=r7, r8=r8, r9=r9,
            r14=r14, r23=r23, cache={})
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


class _Every:
    """Holds every primitive: with it as ``ELEMENTWISE_FREE`` the JAX
    counter counts the products' FLOPs and nothing else."""

    def __contains__(self, name):
        return True


def _jax_dots(ref, monkeypatch, fn, *args) -> int:
    monkeypatch.setattr(ref.flops, "ELEMENTWISE_FREE", _Every())
    return ref.flops.cost_of(fn, *args)["flops"]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --- the per-op rules ---------------------------------------------------------

def _rand(*shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("op", ["mm", "addmm", "bmm", "baddbmm",
                                "_grouped_mm", "_grouped_mm_k"])
def test_product_rules(op):
    """2·(output elements)·K FLOPs, all of them matmul FLOPs; bytes of the
    inputs and the output."""
    offs = torch.tensor([3, 3, 8], dtype=torch.int32)
    cases = {
        "mm": (lambda a, b: torch.mm(a, b), (_rand(5, 7), _rand(7, 3)),
               2 * 5 * 3 * 7),
        "addmm": (lambda c, a, b: torch.addmm(c, a, b),
                  (_rand(3), _rand(5, 7), _rand(7, 3)), 2 * 5 * 3 * 7),
        "bmm": (lambda a, b: torch.bmm(a, b), (_rand(4, 5, 7), _rand(4, 7, 3)),
                2 * 4 * 5 * 3 * 7),
        "baddbmm": (lambda c, a, b: torch.baddbmm(c, a, b),
                    (_rand(4, 5, 3), _rand(4, 5, 7), _rand(4, 7, 3)),
                    2 * 4 * 5 * 3 * 7),
        # (T, D) rows grouped over (E, D, F): 2·T·D·F
        "_grouped_mm": (lambda a, b: torch._grouped_mm(a, b, offs=offs),
                        (_rand(8, 4), _rand(3, 4, 12)), 2 * 8 * 4 * 12),
        # groups along K, as in the backward's weight gradient: (D, T) by
        # (T, F) gives (E, D, F), 2·D·T·F
        "_grouped_mm_k": (lambda a, b: torch._grouped_mm(a, b, offs=offs),
                          (_rand(8, 4).t().contiguous(), _rand(8, 12)),
                          2 * 4 * 8 * 12),
    }
    fn, args, want = cases[op]
    out = fn(*args)
    got = flops.cost_of(fn, *args)
    offsets = (offs,) if op.startswith("_grouped_mm") else ()
    assert got == dict(flops=want, matmul_flops=want, kernels={},
                       bytes=_nbytes(*args, *offsets, out))


@pytest.mark.parametrize("op", [
    lambda x: x.view(6, 4), lambda x: x.reshape(4, 6), lambda x: x.t(),
    lambda x: x.transpose(0, 1), lambda x: x.permute(1, 0),
    lambda x: x[None].expand(3, 4, 6), lambda x: x[:, None].squeeze(1),
    lambda x: x[1:3], lambda x: x[2], lambda x: x.detach(),
    lambda x: x.unsqueeze(0), lambda x: torch.split(x, 2)])
def test_views_count_nothing(op):
    got = flops.cost_of(op, _rand(4, 6))
    assert got == dict(flops=0, bytes=0, matmul_flops=0, kernels={})


@pytest.mark.parametrize("case", [
    "to", "copy_", "clone", "cat", "index", "gather", "scatter",
    "scatter_add", "index_put_", "pad", "flip", "zeros", "arange",
    "empty_like"])
def test_data_movement_counts_bytes_only(case):
    x = _rand(4, 6)
    idx = torch.tensor([[0, 2, 1, 0, 3, 5]] * 4)
    rows = torch.tensor([3, 0])
    cases = {
        "to": (lambda: x.to(torch.float64), (x,)),
        "copy_": (lambda: torch.empty(4, 6).copy_(x), None),
        "clone": (lambda: x.clone(), (x,)),
        "cat": (lambda: torch.cat([x, x]), (x, x)),
        "index": (lambda: x[rows], (x, rows)),
        "gather": (lambda: x.gather(1, idx), (x, idx)),
        "scatter": (lambda: x.scatter(1, idx, x), (x, idx, x)),
        "scatter_add": (lambda: x.scatter_add(1, idx, x), (x, idx, x)),
        "index_put_": (lambda: x.clone().index_put_((rows,), x[:2]), None),
        "pad": (lambda: torch.nn.functional.pad(x, (1, 2)), (x,)),
        "flip": (lambda: x.flip(0), (x,)),
        "zeros": (lambda: torch.zeros(5, 7), ()),
        "arange": (lambda: torch.arange(9), ()),
        "empty_like": (lambda: torch.empty_like(x), (x,)),
    }
    fn, ins = cases[case]
    got = flops.cost_of(fn)
    assert got["flops"] == got["matmul_flops"] == 0
    if ins is not None:          # one op: its inputs and its output
        assert got["bytes"] == _nbytes(*ins, fn())
    else:                        # a factory or a clone, then the op
        assert got["bytes"] > 0


def test_other_ops_count_an_element_each():
    """One FLOP an output element, bytes of inputs and outputs; an in-place
    op that returns nothing counts the tensors it writes."""
    x, y = _rand(4, 6), _rand(6)
    got = flops.cost_of(torch.add, x, y)
    assert got["flops"] == 24 and got["matmul_flops"] == 0
    assert got["bytes"] == _nbytes(x, y, x)
    got = flops.cost_of(lambda: x.sum(dim=1))
    assert got["flops"] == 4 and got["bytes"] == _nbytes(x) + 4 * 4
    xs, ys = [_rand(3), _rand(5)], [_rand(3), _rand(5)]
    got = flops.cost_of(torch._foreach_add_, xs, ys)
    assert got["flops"] == 8 and got["bytes"] == 2 * _nbytes(*xs, *ys) - \
        _nbytes(*ys)


def test_counter_sees_the_backward_and_the_recompute():
    """A backward's ops and a ``torch.utils.checkpoint`` recompute are
    counted: the checkpointed product, whose output the next op saves,
    costs its forward once more.  (The recompute runs only as far as the
    last saved tensor: a product whose inputs are the last ones saved is
    not run again, and not counted.)"""
    a = _rand(8, 16).requires_grad_()
    w = _rand(16, 4).requires_grad_()

    def fn(t):
        return torch.sin(torch.mm(t * 2, w))

    def run(ckpt):
        out = (torch.utils.checkpoint.checkpoint(fn, a, use_reentrant=False)
               if ckpt else fn(a))
        out.sum().backward()

    plain, ckpt = flops.cost_of(run, False), flops.cost_of(run, True)
    fwd = 2 * 8 * 4 * 16
    assert plain["matmul_flops"] == 3 * fwd     # forward, grads of a and w
    assert ckpt["matmul_flops"] == 4 * fwd      # and the recompute


def test_no_counter_no_charge():
    """With no counter active the entries call straight through: no
    record, the same output, no launch counted on the CPU."""
    assert flops.active() is None
    flops.charge("flash_attention", flops=1, bytes=1, matmul_flops=1)
    q = _rand(1, 2, 8, 8)
    before = dict(kernels.LAUNCHES)
    out = k6.flash_attention(q, q, q)
    assert torch.equal(out, k6.flash_attention_plain(q, q, q))
    assert kernels.LAUNCHES == before


# --- the kernels --------------------------------------------------------------

def _flipped64(g, n):
    return torch.from_numpy(g.integers(-2 ** 63, 2 ** 63 - 1, n,
                                       dtype=np.int64))


def _kernel_case(name, shape, ref):
    """(port entry, its args, the charge's name, the JAX reference and its
    abstract args) for kernel ``name`` at shape case ``shape`` (0 or 1)."""
    g = np.random.default_rng(shape)
    sds = ref.jax.ShapeDtypeStruct
    i32, u32, f32 = np.int32, np.uint32, np.float32
    if name in ("K1", "K2", "K4"):
        m = (37, 1000)[shape]
        seg = torch.from_numpy(np.sort(g.integers(0, m // 3 + 1, m))
                               .astype(np.int32))
        if name == "K1":
            return (k14.segmented_min2_scan, (seg, _flipped64(g, m)),
                    "segmented_min2_scan", ref.r14.segmented_min2_scan,
                    (sds((m,), i32), sds((m,), u32), sds((m,), u32)))
        if name == "K4":
            val = torch.from_numpy(g.integers(-2 ** 31, 2 ** 31 - 1, m,
                                              dtype=np.int32))
            return (k14.segmented_min_scan, (seg, val), "segmented_min_scan",
                    ref.r14.segmented_min_scan,
                    (sds((m,), i32), sds((m,), u32)))
        oth = torch.from_numpy(g.integers(0, m // 3 + 1, m).astype(np.int32))
        return (k23.masked_minplus_scan, (seg, oth, _flipped64(g, m)),
                "masked_minplus_scan",
                lambda cs, cd, key: ref.r23.elect(cs, cd, key,
                                                  num_segments=m // 3 + 1),
                (sds((m,), i32), sds((m,), i32), sds((m,), np.uint64)))
    if name == "K3":
        n, m = ((50, 70), (777, 300))[shape]
        parent = torch.from_numpy(
            (np.arange(n) * g.random(n)).astype(np.int32))
        comp = torch.from_numpy(g.integers(0, n, m).astype(np.int32))
        return (k23.pointer_jump, (parent, comp), "pointer_jump",
                ref.r23.shortcut_relabel, (sds((n,), i32), sds((m,), i32)))
    if name == "K5":
        e, q = ((20, 31), (300, 450))[shape]
        lv, u = g.integers(0, 50, e), g.integers(0, 50, e)
        tab = hash_ops.build_table(lv, u, np.arange(e), 4 * e + 1)
        t = tab[0].shape[0]
        args = tuple(torch.from_numpy(a) for a in tab) + (
            torch.from_numpy(g.integers(0, 50, q).astype(np.int32)),
            torch.from_numpy(g.integers(0, 50, q).astype(np.int32)))
        return (k5.hash_lookup, args, "hash_lookup", ref.r5.hash_lookup,
                (sds((t,), i32),) * 3 + (sds((q,), i32),) * 2)
    if name in ("K6", "K7"):
        b, hq, hkv, s, skv, d = ((2, 4, 2, 32, 32, 16),
                                 (1, 6, 3, 24, 40, 8))[shape]
        k = torch.from_numpy(g.standard_normal((b, hkv, skv, d), f32))
        v = torch.from_numpy(g.standard_normal((b, hkv, skv, d), f32))
        if name == "K6":
            causal = shape == 0
            q = torch.from_numpy(g.standard_normal((b, hq, s, d), f32))
            return (lambda *a: k6.flash_attention(*a, causal=causal),
                    (q, k, v), "flash_attention",
                    lambda *a: ref.r6.attention(*a, causal=causal),
                    (sds(q.shape, f32), sds(k.shape, f32), sds(v.shape, f32)))
        q = torch.from_numpy(g.standard_normal((b, hq, d), f32))
        length = torch.from_numpy(g.integers(1, skv + 1, b).astype(np.int32))
        return (k7.decode_attention, (q, k, v, length), "decode_attention",
                ref.r7.decode_attention,
                (sds(q.shape, f32), sds(k.shape, f32), sds(v.shape, f32),
                 sds((b,), i32)))
    if name == "K8":
        bsz, t, dim, n = ((2, 16, 32, 8), (1, 40, 24, 16))[shape]
        x, dt = (torch.from_numpy(g.standard_normal((bsz, t, dim), f32))
                 for _ in range(2))
        bb, cc = (torch.from_numpy(g.standard_normal((bsz, t, n), f32))
                  for _ in range(2))
        a = torch.from_numpy(-g.random((dim, n), f32))
        dd = torch.from_numpy(g.standard_normal(dim, f32))
        args = (x, dt.abs() * 0.1, bb, cc, a, dd)
        return (k8.selective_scan, args, "selective_scan",
                ref.r8.selective_scan,
                tuple(sds(z.shape, f32) for z in args))
    bh, t, d = ((2, 16, 16), (3, 24, 64))[shape]                      # K9
    r, k, v = (torch.from_numpy(g.standard_normal((bh, t, d), f32))
               for _ in range(3))
    w = torch.from_numpy(g.uniform(0.5, 0.99, (bh, t, d)).astype(f32))
    u = torch.from_numpy(g.standard_normal((bh, d), f32))
    return (k9.wkv6, (r, k, v, w, u), "wkv6", ref.r9.wkv6,
            tuple(sds(z.shape, f32) for z in (r, k, v, w, u)))


@pytest.mark.parametrize("shape", [0, 1])
@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "K5", "K6", "K7",
                                  "K8", "K9"])
def test_kernel_charge(ref, monkeypatch, name, shape):
    """The counter's whole count of a kernel call is its charge; the charge
    is the one rule; its matmul FLOPs are the JAX reference's dot FLOPs at
    these shapes; with no counter the output and LAUNCHES are unchanged."""
    fn, args, charged, rfn, rargs = _kernel_case(name, shape, ref)
    before = dict(kernels.LAUNCHES)
    plain = fn(*args)
    with flops.CostCounter() as counter:
        out = fn(*args)
    got = counter.result()
    assert kernels.LAUNCHES == before
    assert torch.equal(out, plain)
    if name == "K2":
        with ref.jax.enable_x64():
            want_mm = _jax_dots(ref, monkeypatch, rfn, *rargs)
    else:
        want_mm = _jax_dots(ref, monkeypatch, rfn, *rargs)
    assert got["kernels"] == {charged: dict(
        calls=1, flops=out.numel() + want_mm,
        bytes=_nbytes(*args, out), matmul_flops=want_mm)}
    assert {k: got[k] for k in ("flops", "bytes", "matmul_flops")} == {
        k: v for k, v in got["kernels"][charged].items() if k != "calls"}
    if name in ("K6", "K7"):
        q, k = args[0], args[1]
        assert want_mm == 4 * q.numel() * k.shape[2] > 0
    else:
        assert want_mm == 0


def test_records_entry_and_nested_entries_charge_once():
    """``hash_lookup_records`` charges under the same name by its own
    inputs; an entry called inside another (the three-array entry packs and
    calls the records entry on the card) is hidden with the rest of the
    call."""
    g = np.random.default_rng(3)
    tab = hash_ops.build_table(g.integers(0, 9, 30), g.integers(0, 9, 30),
                               np.arange(30), 121)
    records = hash_ops.pack_table(tab, "cpu")
    q = torch.from_numpy(g.integers(0, 9, 17).astype(np.int32))
    with flops.CostCounter() as counter:
        out = k5.hash_lookup_records(records, q, q)
    assert counter.result()["kernels"] == {"hash_lookup": dict(
        calls=1, flops=17, bytes=_nbytes(records, q, out), matmul_flops=0)}
    assert counter.result()["bytes"] == _nbytes(records, q, out)


def test_ghs_interval_is_charged():
    """The GHS engine's interval kernel is charged once a launch on the
    CPU path too, with no matmul FLOPs."""
    g = generators.rmat(6, seed=2)
    with flops.CostCounter() as counter:
        mst_api.minimum_spanning_forest(g, method="ghs", device="cpu")
    charge = counter.result()["kernels"]["ghs_superstep"]
    assert charge["calls"] >= 1 and charge["matmul_flops"] == 0
    assert charge["flops"] == 3 * charge["calls"]


# --- the models ---------------------------------------------------------------

def _attention_calls(cfg, s):
    """(S_q·S_kv summed over a step's attention calls): the transformer's
    L layers (the VLM's over its patches too), the encoder-decoder's
    encoder, self and cross layers (S_enc = S)."""
    if cfg.family == "encdec":
        return (cfg.n_enc_layers + 2 * cfg.n_layers) * s * s
    if cfg.family == "vlm":
        s += cfg.n_frontend_tokens
    return cfg.n_layers * s * s


def _moe_layers(cfg):
    if cfg.family == "hybrid":
        return 4 * (cfg.n_layers // 8)
    return cfg.n_layers if cfg.family == "moe" else 0


def _port_minus_jax(cfg, step, b, s, remat="none"):
    """The port's matmul FLOPs less the JAX counter's dot FLOPs, written
    out term by term (the module docstring gives each reason)."""
    t = b * (1 if step == "decode" else s)
    extra = 0
    # H18: the expert products, 3 a forward pass; a train step's backward
    # adds 6, the recompute of remat "full" 3 more
    passes = dict(loss=3, prefill=3, decode=3)
    passes.update(train_none=9, train_full=12)
    grouped = 2 * t * cfg.top_k * cfg.d_model * cfg.d_expert
    extra += _moe_layers(cfg) * passes[step if step != "train" else
                                       f"train_{remat}"] * grouped
    if step == "train":          # the logits recomputed in each backward
        extra += 2 * b * cfg.n_heads * cfg.hd * _attention_calls(cfg, s)
    if cfg.family == "hybrid" and step in ("loss", "prefill"):
        mamba = 7 * (cfg.n_layers // 8)
        extra -= mamba * 2 * t * cfg.d_inner * cfg.d_conv   # the conv
        if step == "prefill":                               # in_proj again
            extra -= mamba * 2 * t * cfg.d_model * 2 * cfg.d_inner
    if cfg.family == "encdec" and step == "prefill":
        extra -= cfg.n_layers * 2 * 2 * b * s * cfg.d_model * cfg.kv_dim
    return extra


def _jax_step(ref, monkeypatch, arch, step, b, s, remat):
    """The JAX counter's dot FLOPs of one step of ``arch``'s smoke config
    (abstract parameters and state; ``synth_batch(0)``), once a module."""
    key = (arch, step, b, s, remat)
    if key in ref.cache:
        return ref.cache[key]
    jax = ref.jax
    rcfg = ref.configs.get_config(arch, True)
    model = ref.api.get_model(rcfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), rcfg))
    batch = {k: np.asarray(v) for k, v in
             ref.api.synth_batch(0, rcfg, b, s).items()}
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    if step == "loss":
        n = _jax_dots(ref, monkeypatch,
                      lambda p, x: model.loss_fn(p, x, rcfg), params, batch)
    elif step == "train":
        state = jax.eval_shape(lambda: ref.train.init_train_state(
            jax.random.PRNGKey(0), rcfg))
        n = _jax_dots(ref, monkeypatch, ref.train.make_train_step(
            rcfg, ref.train.TrainHParams(remat=remat)), state, batch)
    else:
        pre = ref.serve.make_prefill_step(rcfg, max_len=s + GEN)
        if step == "prefill":
            n = _jax_dots(ref, monkeypatch, pre, params, prompt)
        else:
            _, cache = jax.eval_shape(pre, params, prompt)
            n = _jax_dots(ref, monkeypatch, ref.serve.make_decode_step(rcfg),
                          params, cache, np.zeros((b, 1), np.int32))
    ref.cache[key] = n
    return n


def _port_step(arch, step, b, s, remat="none"):
    """The port's count of the same step, smoke config, on the CPU."""
    cfg = get_config(arch, True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    model = state["params"]
    batch = api.synth_batch(0, cfg, b, s, device="cpu")
    if step == "train":
        return flops.cost_of(make_train_step(cfg, TrainHParams(remat=remat)),
                             state, batch)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        if step == "loss":
            return flops.cost_of(api.get_model(cfg).loss_fn, model, batch,
                                 cfg)
        pre = serve_step.make_prefill_step(cfg, max_len=s + GEN)
        if step == "prefill":
            return flops.cost_of(pre, model, prompt)
        _, cache = pre(model, prompt)
        return flops.cost_of(serve_step.make_decode_step(cfg), model, cache,
                             torch.zeros((b, 1), dtype=torch.int32))


@pytest.mark.parametrize("step", ["loss", "prefill", "decode"])
@pytest.mark.parametrize("arch", list_archs())
def test_model_steps_match_reference(ref, monkeypatch, arch, step):
    cfg = get_config(arch, True)
    got = _port_step(arch, step, B, S)["matmul_flops"]
    want = _jax_step(ref, monkeypatch, arch, step, B, S, None)
    assert got == want + _port_minus_jax(cfg, step, B, S)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", TRAINED)
def test_train_steps_match_reference(ref, monkeypatch, arch, remat):
    cfg = get_config(arch, True)
    got = _port_step(arch, "train", B, S, remat)["matmul_flops"]
    want = _jax_step(ref, monkeypatch, arch, "train", B, S, remat)
    assert got == want + _port_minus_jax(cfg, "train", B, S, remat)


def test_predicted_dense_step(ref, monkeypatch):
    """Qwen1.5-0.5B's smoke config, batch 2, seq 128, remat none: the JAX
    counter's 254,803,968 dot FLOPs (6·N·T + 12·L·d·S·T), and the port's
    263,192,576, the logits recomputed in 2 layers' backward added."""
    want = _jax_step(ref, monkeypatch, "qwen1.5-0.5b", "train", 2, 128,
                     "none")
    got = _port_step("qwen1.5-0.5b", "train", 2, 128)
    assert want == 254_803_968
    assert got["matmul_flops"] == 263_192_576 == want + 2 * (
        2 * 2 * 4 * 128 * 128 * 16)
    assert got["kernels"]["flash_attention"]["calls"] == 2


def test_two_chunk_loss_and_the_chip_formula(ref, monkeypatch):
    """At S = 1,024 the chunked loss runs two chunks of 512, each head
    recomputed in the backward on both sides; the port's count is also
    ``chip_smoke._dense_train_matmul_flops``, the formula phase 9b holds
    Qwen1.5-0.5B's full config to."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = get_config("qwen1.5-0.5b", True)
    want = _jax_step(ref, monkeypatch, "qwen1.5-0.5b", "train", 1, 1024,
                     "none")
    got = _port_step("qwen1.5-0.5b", "train", 1, 1024)["matmul_flops"]
    assert got == want + _port_minus_jax(cfg, "train", 1, 1024)
    assert got == chip_smoke._dense_train_matmul_flops(cfg, 1, 1024)
    assert chip_smoke._dense_train_matmul_flops(cfg, 2, 128) == 263_192_576


def test_checkpoint_recompute_matches_reference(ref, monkeypatch):
    """remat ``full`` less ``none`` on the dense smoke step: the same on
    both counters."""
    arch = "qwen1.5-0.5b"
    got = (_port_step(arch, "train", B, S, "full")["matmul_flops"]
           - _port_step(arch, "train", B, S, "none")["matmul_flops"])
    want = (_jax_step(ref, monkeypatch, arch, "train", B, S, "full")
            - _jax_step(ref, monkeypatch, arch, "train", B, S, "none"))
    assert got == want > 0


# --- platform ----------------------------------------------------------------

def test_set_platform_rejects_unknown_names():
    for name in ("tpu", "cuda", ""):
        with pytest.raises(ValueError, match="unknown platform"):
            platform.set_platform(name)


def test_set_platform_too_late_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    for name in ("cpu", "gpu"):
        with pytest.raises(RuntimeError, match="before CUDA initializes"):
            platform.set_platform(name)


def test_set_platform_cpu_hides_the_cards(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = platform.pin("cpu")
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    assert got["platform"] == "cpu" and got["count"] == 0


def test_set_platform_gpu_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform.set_platform("gpu")


def test_debug_nan_raises_at_a_nan_made_in_a_backward():
    x = torch.zeros(3, requires_grad=True)
    try:
        got = platform.pin(debug_nan=True)
        assert got["debug_nan"]
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0).sum().backward()
    finally:
        platform.set_debug_nan(False)
    (torch.sqrt(x) * 0).sum().backward()         # off again: no raise
    assert torch.isnan(x.grad).all()


# --- on the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_gpu_counts_equal_cpu(cuda, arch):
    """Phase 11a of ``chip_smoke.py`` on one arch: every total and every
    kernel's charge equal on the card and the CPU, calls equal to
    launches."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    card = chip_smoke._count_arch(torch, arch, cuda)
    chip_smoke._same_counts(arch, card, chip_smoke._count_arch(
        torch, arch, torch.device("cpu")))
    assert card["train"]["launches"]


@pytest.mark.gpu
def test_gpu_pin_turns_tf32_off(cuda):
    """``pin("gpu")`` in a process where CUDA has not started: TF32 off
    for matmuls and cuDNN, the card named."""
    code = ("import torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "torch.backends.cudnn.allow_tf32 = True\n"
            "from repro_torch import platform\n"
            "got = platform.pin('gpu')\n"
            "assert got['tf32'] == dict(matmul=False, cudnn=False), got\n"
            "assert got['count'] >= 1 and got['platform'] == 'gpu', got\n"
            "print('pinned', got['device'])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "pinned" in out.stdout

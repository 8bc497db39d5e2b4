"""The port's attention kernels — flash attention (K6) and decode attention
(K7) — held against the JAX package's Pallas kernels, run in interpret
mode, and against its plain oracles.

On the CPU each wrapper runs its kernel's plain PyTorch version; the tests
marked ``gpu`` compare the CUDA kernels with those plain versions on the
card and skip without one.

Tolerances: the seed's own for a kernel against its oracle
(``tests/test_kernels.py``): 2e-3 in float32 and 3e-2 in bfloat16.  On the
card the kernel and its plain version both compute in float32 from the same
inputs and differ only in the order of their sums: 1e-4 (times the largest
output, when that is above 1) in float32; in bfloat16 the two float32
results may round to neighbouring values, so two bf16 ulps of each output
(2**-6 of it) plus 1e-5.

K7 splits the cache into chunks (``split_plan``), one block each, and
combines the chunks' partial softmax sums; a CPU test emulates that
arithmetic and holds it to the card tolerance above.

K6's bf16 instance runs both products on the tensor cores: scores from bf16
q and k summed in float32, and P fed to P·V as two bf16 halves (p_hi =
bf16(p), p_lo = bf16(p - p_hi)).  A CPU test emulates that arithmetic and
shows it within the card tolerance above, where P as one bf16 is not.

At head dim 128 with q scaled by 50 (fault F2 in ROADMAP.md) the scores
reach about 160, where a float32 ulp is 1.5e-5, and the float32 plain
versions themselves differ from exact attention by about the 1e-5 floor on
outputs that cancel between two keys; there the kernels are held to the
same card tolerance against attention computed in float64
(``_attention_f64``).  A CPU test models K7's order of a score's sums (a
chain of fused multiply-adds within each 16-byte piece, the pieces added
as a balanced tree) against that reference.
"""
import inspect
import math
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import decode_attention as dec_mod
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention, decode_attention_plain, split_plan)
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_plain)

F32_TOL = 2e-3
BF16_TOL = 3e-2
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, Hq, Hkv, S, D): the seed's sweep shapes, then GQA groups 2 and 5,
# then Phi-3's head dims, 96 and its smoke config's 24 (fault F1; the
# Pallas kernel takes the whole head dim as one block, so it runs both)
FLASH_CASES = [(1, 4, 4, 256, 64), (2, 8, 2, 512, 128), (1, 4, 1, 256, 64),
               (1, 4, 2, 256, 64), (1, 10, 2, 256, 64), (2, 4, 2, 128, 24),
               (2, 4, 2, 128, 96)]
# the seed's decode sweep shapes (groups 4 and 1), then group 5, then
# Phi-3's head dims
DECODE_CASES = [(2, 8, 2, 1024, 64), (1, 4, 4, 2048, 128),
                (3, 10, 2, 512, 64), (3, 8, 8, 512, 24), (3, 8, 8, 512, 96)]
LENGTHS = ["zero", "one", "random", "full"]


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's attention kernels and oracles, imported for this
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
        from repro.kernels.decode_attention import decode_attention as dk
        from repro.kernels.decode_attention import ref as dr
        from repro.kernels.flash_attention import flash_attention as fk
        from repro.kernels.flash_attention import ref as fr
        yield types.SimpleNamespace(jnp=jnp, flash=fk, flash_ref=fr,
                                    decode=dk, decode_ref=dr)
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


def _qkv(b, hq, hkv, s, d, *, seed=0, decode=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d) if decode else (b, hq, s, d))
    k = rng.standard_normal((b, hkv, s, d))
    v = rng.standard_normal((b, hkv, s, d))
    return [a.astype(np.float32) for a in (q, k, v)]


def _lengths(kind, b, s, seed=0):
    rng = np.random.default_rng(seed + 1)
    return {"zero": np.zeros(b), "one": np.ones(b),
            "random": rng.integers(1, s, b),
            "full": np.full(b, s)}[kind].astype(np.int32)


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _jax(ref, arrays, dtype):
    return [ref.jnp.asarray(a, getattr(ref.jnp, dtype)) for a in arrays]


def _err(got, want) -> float:
    return float((got.float() - torch.from_numpy(np.array(
        want, np.float32))).abs().max())


# --- flash attention (K6) ----------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(ref, case, causal, dtype):
    arrays = _qkv(*case)
    want = ref.flash.flash_attention(*_jax(ref, arrays, dtype), causal=causal,
                                     interpret=True)
    got = attn_ops.attention(*_torch(arrays, DTYPES[dtype]), causal=causal)
    assert got.dtype == DTYPES[dtype] and got.shape == case[:2] + case[3:]
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert _err(got, want.astype(ref.jnp.float32)) < tol


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [77, 1000])
def test_flash_attention_plain_matches_ref_ragged(ref, s, causal):
    """Lengths the Pallas kernel's tiling refuses: the oracle takes them."""
    arrays = _qkv(1, 4, 2, s, 64, seed=s)
    want = ref.flash_ref.attention(*_jax(ref, arrays, "float32"),
                                   causal=causal)
    got = flash_attention(*_torch(arrays, torch.float32), causal=causal)
    assert _err(got, want) < F32_TOL


def _cancelling_qkv(b, hq, hkv, s, d, *, ramp, seed=0):
    """Keys along one direction, k_j = (1 + ramp·j/S)·k_0, and v of
    alternating sign, v_j = (-1)^j·u: every output is an alternating sum of
    smooth probabilities, near zero.  With ramp 0 (equal keys) the
    probabilities of a row are equal and an even count of keys cancels
    exactly; with a ramp they differ from key to key."""
    rng = np.random.default_rng(seed)
    scale = 1 + ramp * np.arange(s) / s
    sign = np.where(np.arange(s) % 2 == 0, 1.0, -1.0)
    k = scale[:, None] * rng.standard_normal(d)[None]
    v = sign[:, None] * rng.standard_normal(d)[None]
    q = rng.standard_normal((b, hq, s, d))
    return [np.ascontiguousarray(a, np.float32) for a in
            (q, np.broadcast_to(k, (b, hkv, s, d)),
             np.broadcast_to(v, (b, hkv, s, d)))]


def _tensor_core_flash(q, k, v, *, causal=True, split=True, tile=64):
    """What K6's bf16 instance computes, in plain torch: scores of bf16 q
    and k summed in float32 and scaled by scale·log2(e), an online softmax
    over key tiles with exp2, and P·V with P rounded to bf16, as two halves
    P_hi·V + P_lo·V when ``split`` and as P_hi·V alone otherwise."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    sl2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, hq, s), -1e30)
    l = torch.zeros(b, hq, s)
    acc = torch.zeros(b, hq, s, d)
    rows = torch.arange(s)
    for k0 in range(0, s, tile):
        keys = torch.arange(k0, min(k0 + tile, s))
        ok = keys[None] <= rows[:, None] if causal else \
            torch.ones(s, len(keys), dtype=torch.bool)
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, keys]) * sl2
        sc = torch.where(ok, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vf[:, :, keys]
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vf[:, :, keys]
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("inputs", ["random", "cancelling"])
def test_bf16_flash_needs_p_as_two_bf16_halves(inputs):
    """The numerical argument of K6's bf16 instance, at a served-like shape
    (B 1, 4 heads, S 256, hd 64): with P as two bf16 halves every output is
    within the card tolerance of the plain version; with P as one bf16 at
    least one output is not."""
    arrays = (_qkv(1, 4, 4, 256, 64) if inputs == "random" else
              _cancelling_qkv(1, 4, 4, 256, 64, ramp=1.0))
    q, k, v = _torch(arrays, torch.bfloat16)
    for causal in (True, False):
        want = flash_attention_plain(q, k, v, causal=causal)
        tol = _card_tol(want)
        split = _tensor_core_flash(q, k, v, causal=causal)
        single = _tensor_core_flash(q, k, v, causal=causal, split=False)
        assert split.dtype == torch.bfloat16
        assert bool(((split.float() - want.float()).abs() <= tol).all())
        assert bool(((single.float() - want.float()).abs() > tol).any())


def test_attention_wrappers_check_inputs():
    q, k, v = _torch(_qkv(1, 4, 2, 16, 16), torch.float32)
    before = dict(kernels.LAUNCHES)
    flash_attention(q, k, v)
    decode_attention(q[:, :, 0], k, v, torch.ones(1, dtype=torch.int32))
    assert kernels.LAUNCHES == before          # the CPU launches nothing
    with pytest.raises(ValueError, match="group"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :8], k, v)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k, v)
    with pytest.raises(ValueError, match="length"):
        decode_attention(q[:, :, 0], k, v, torch.ones(1, dtype=torch.int64))
    # meta tensors (the dry run): an empty output of the plain version's
    # shape and type, no launch
    meta = [t.to("meta") for t in (q, k, v)]
    out = flash_attention(*meta)
    assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape,
                                                       q.dtype)
    out = decode_attention(meta[0][:, :, 0], meta[1], meta[2],
                           torch.ones(1, dtype=torch.int32, device="meta"))
    assert (out.device.type, out.shape) == ("meta", q[:, :, 0].shape)
    with pytest.raises(ValueError, match="q's device"):
        decode_attention(meta[0][:, :, 0], meta[1], meta[2],
                         torch.ones(1, dtype=torch.int32))
    assert kernels.LAUNCHES == before


# --- decode attention (K7) ---------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lengths", LENGTHS)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_plain_matches_pallas(ref, case, lengths, dtype):
    b, hq, hkv, s, d = case
    arrays = _qkv(*case, decode=True)
    ln = _lengths(lengths, b, s)
    want = ref.decode.decode_attention(*_jax(ref, arrays, dtype),
                                       ref.jnp.asarray(ln), interpret=True)
    got = dec_ops.decode_attention(*_torch(arrays, DTYPES[dtype]),
                                   torch.from_numpy(ln))
    assert got.dtype == DTYPES[dtype] and got.shape == (b, hq, d)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert _err(got, want.astype(ref.jnp.float32)) < tol


def test_decode_attention_zero_length_is_mean_of_v():
    """Hazard H7: every logit of a row with length 0 is -1e30, so each
    p = exp(0) = 1 and the row's output is V's mean over all S."""
    q, k, v = _torch(_qkv(2, 4, 2, 77, 16, decode=True), torch.float32)
    got = decode_attention(q, k, v, torch.tensor([0, 77], dtype=torch.int32))
    want = v[0].mean(dim=1).repeat_interleave(2, dim=0)
    assert float((got[0] - want).abs().max()) < 1e-6


@pytest.mark.parametrize("s", [77, 1000])
def test_decode_attention_plain_matches_ref_ragged(ref, s):
    arrays = _qkv(3, 10, 2, s, 64, seed=s, decode=True)
    ln = np.array([0, 1, s - 3], np.int32)
    want = ref.decode_ref.decode_attention(*_jax(ref, arrays, "float32"),
                                           ref.jnp.asarray(ln))
    got = decode_attention(*_torch(arrays, torch.float32), torch.from_numpy(ln))
    assert _err(got, want) < F32_TOL


# --- K7's split (split-K flash decoding), emulated on the CPU ----------------

# (B, Hq, Hkv, S, D) of the decode steps the port serves: Qwen1.5-0.5B
# (cache 1024 + 512), Qwen2.5-14B, Phi-3-mini, Jamba and Qwen2-MoE (cache
# 1024 + 32), at batch 8 (14B at 4)
SERVED_DECODE = {"qwen1.5-0.5b": (8, 16, 16, 1536, 64),
                 "qwen2.5-14b": (4, 40, 8, 1056, 128),
                 "phi3-mini": (8, 32, 32, 1056, 96),
                 "jamba": (8, 32, 8, 1056, 128),
                 "qwen2-moe": (8, 16, 16, 1056, 128)}
H100_SMS = 132


@pytest.mark.parametrize("name", list(SERVED_DECODE))
def test_split_plan_covers_the_cache(name):
    """The chunks cover S, a chunk is a whole number of tiles, the grid is
    (chunks, kv heads x head tiles, B) and fills the card's 132 SMs."""
    b, hq, hkv, s, d = SERVED_DECODE[name]
    chunk, chunks, grid = split_plan(b, hq, hkv, s, d, H100_SMS)
    assert chunk % dec_mod.TILE == 0 and chunk > 0
    assert (chunks - 1) * chunk < s <= chunks * chunk
    head_tiles = -(-(hq // hkv) // dec_mod.HEADS_PER_BLOCK)
    assert grid == (chunks, hkv * head_tiles, b)
    assert math.prod(grid) >= H100_SMS


def test_split_plan_takes_no_length():
    """The plan is a function of shapes only: the lengths stay on the
    device, and the served decode loop allows no host read of them."""
    assert list(inspect.signature(split_plan).parameters) == [
        "b", "hq", "hkv", "s", "d", "sm_count"]


def _split_decode(q, k, v, length, sm_count, scale=None):
    """What K7 computes, in plain torch: the cache cut by ``split_plan``;
    in each chunk an online softmax over its 32-row tiles in order (the
    tile's max and sum, then the rescale) gives the chunk's partial (m, l,
    acc), an empty chunk's being (-1e30, 0, 0); then the chunks are
    combined, o = sum_c acc_c e^(m_c - m) / max(sum_c l_c e^(m_c - m),
    1e-30)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    chunk, chunks, _ = split_plan(b, hq, hkv, s, d, sm_count)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = q.float()
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    uniform = length <= 0
    n = torch.where(uniform, s, length.clamp(max=s))
    ms, ls, accs = [], [], []
    for c in range(chunks):
        hi = n.clamp(max=(c + 1) * chunk)
        m = torch.full((b, hq), -1e30)
        l = torch.zeros(b, hq)
        acc = torch.zeros(b, hq, d)
        for r0 in range(c * chunk, min((c + 1) * chunk, s), dec_mod.TILE):
            rows = torch.arange(r0, min(r0 + dec_mod.TILE, s))
            ok = (rows[None] < hi[:, None])[:, None]             # (B, 1, R)
            sc = torch.einsum("bhd,bhrd->bhr", qf, kf[:, :, rows]) * scale
            sc = torch.where(uniform[:, None, None], 0.0, sc)
            m_new = torch.maximum(m, torch.where(ok, sc, -1e30).amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhr,bhrd->bhd", p, vf[:, :, rows])
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    ms = torch.stack(ms)
    f = torch.exp(ms - ms.amax(0))
    den = (torch.stack(ls) * f).sum(0)
    num = (torch.stack(accs) * f[..., None]).sum(0)
    return (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)


# (B, Hq, Hkv, S, D, SMs): Qwen1.5-0.5B's served decode, GQA group 5 at
# hd 128, group 10 (two head tiles) at hd 24 and S 300; each in several
# chunks on 132 SMs
SPLIT_CASES = [(6, 16, 16, 1536, 64, 132), (6, 10, 2, 1056, 128, 132),
               (6, 20, 2, 300, 24, 132)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_decode_emulation_matches_plain(case, dtype):
    """The split's arithmetic (per-chunk online softmax, empty partials,
    the combine) against the plain version within the card tolerance, at
    lengths -1, 0, 1, mid, S and S + 5, one a row; every output finite."""
    b, hq, hkv, s, d, sms = case
    assert split_plan(b, hq, hkv, s, d, sms)[1] > 1
    q, k, v = _torch(_qkv(b, hq, hkv, s, d, seed=s, decode=True),
                     DTYPES[dtype])
    length = torch.tensor([-1, 0, 1, s // 2 + 7, s, s + 5], dtype=torch.int32)
    got = _split_decode(q, k, v, length, sms)
    assert bool(torch.isfinite(got.float()).all())
    _assert_close(got, decode_attention_plain(q, k, v, length))


# --- the CUDA kernels against their plain versions, on the card -------------

def _card_tol(want: torch.Tensor):
    w = want.float()
    if want.dtype == torch.bfloat16:
        return 2.0 ** -6 * w.abs() + 1e-5
    return 1e-4 * max(1.0, float(w.abs().max()))


def _assert_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(((got.float() - want.float()).abs() <= _card_tol(want)).all())


def _print_margin(label, got, want):
    """Print the largest |got - want| over the card tolerance, the margin
    of an F2 case (``pytest -rA`` shows it for passing tests too)."""
    ratio = (got.float() - want.float()).abs() / _card_tol(want)
    print(f"F2 {label}: largest err/tol {float(ratio.max()):.4f}")


def _attention_f64(q, k, v, *, causal=False, length=None):
    """Masked softmax attention from the kernels' inputs, computed in
    float64 and rounded to q's type: K6's (q (B, Hq, S, D), ``causal``) or,
    with ``length``, K7's (q (B, Hq, D), cache positions >= length masked,
    a row with length 0 averaging V as in the plain version).  The plain
    versions compute in float32; this is the reference the float32 sums of
    both the kernel and the plain version are held to."""
    qd, kd, vd = (z.double() for z in (q, k, v))
    group = q.shape[1] // k.shape[1]
    kd = kd.repeat_interleave(group, dim=1)
    vd = vd.repeat_interleave(group, dim=1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if length is None:
        s = q.shape[2]
        logits = torch.einsum("bhqd,bhkd->bhqk", qd, kd) * scale
        if causal:
            mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            logits = torch.where(mask, logits, -1e30)
        return torch.einsum("bhqk,bhkd->bhqd", logits.softmax(-1),
                            vd).to(q.dtype)
    s = k.shape[2]
    logits = torch.einsum("bhd,bhkd->bhk", qd, kd) * scale
    mask = (torch.arange(s, device=q.device)[None, None, :]
            < length.to(q.device)[:, None, None])
    logits = torch.where(mask, logits, -1e30)
    return torch.einsum("bhk,bhkd->bhd", logits.softmax(-1), vd).to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_float64_reference_matches_plain_flash(causal):
    """The float64 reference against K6's plain version, float32 inputs of
    ordinary scale, at hd 128 and a GQA group of 2: within the float32 card
    tolerance, so the two compute the same attention."""
    q, k, v = _torch(_qkv(2, 4, 2, 77, 128, seed=128), torch.float32)
    want = _attention_f64(q, k, v, causal=causal)
    assert want.dtype == torch.float32 and want.shape == q.shape
    _assert_close(flash_attention_plain(q, k, v, causal=causal), want)


def test_float64_reference_matches_plain_decode():
    """The same for K7's plain version, lengths 0 (V averaged), 1, mid and
    S at hd 128 and a GQA group of 5."""
    q, k, v = _torch(_qkv(4, 10, 2, 96, 128, seed=129, decode=True),
                     torch.float32)
    length = torch.tensor([0, 1, 50, 96], dtype=torch.int32)
    want = _attention_f64(q, k, v, length=length)
    assert want.dtype == torch.float32 and want.shape == q.shape
    _assert_close(decode_attention_plain(q, k, v, length), want)


def _decode_scores(q, k, *, tree=True):
    """K7's raw scores q·k (B, Hq, S) as float32 values in float64
    tensors: each 16-byte piece of a row (8 bf16 or 4 float32 elements) a
    chain of fused multiply-adds from 0, the pieces added as a balanced
    tree (the first half's sum plus the second's) or, with ``tree`` False,
    in order.  A fused multiply-add is modelled in float64 (the product of
    two float32 values is exact there) and then rounded to float32."""
    def f32(x):
        return x.float().double()
    e = 16 // q.element_size()
    group = q.shape[1] // k.shape[1]
    qd = q.double()[:, :, None, :]
    kd = k.double().repeat_interleave(group, dim=1)
    pieces = []
    for p0 in range(0, q.shape[-1], e):
        part = torch.zeros(kd.shape[:3], dtype=torch.float64)
        for i in range(p0, p0 + e):
            part = f32(qd[..., i] * kd[..., i] + part)
        pieces.append(part)

    def pair(xs):
        if len(xs) == 1:
            return xs[0]
        h = len(xs) // 2
        return f32(pair(xs[:h]) + pair(xs[h:]))
    if tree:
        return pair(pieces)
    total = pieces[0]
    for x in pieces[1:]:
        total = f32(total + x)
    return total


def test_decode_score_order_meets_float64_at_hd128():
    """Fault F2: at hd 128 with q scaled by 50 (the case of
    ``test_gpu_decode_split_hd128_large_scores_against_float64``), raw
    scores reach about 1800, where a float32 ulp is 1.2e-4.  Summed in K7's
    order, the outputs, softmax and all else taken in float64, meet the
    float64 reference within the card tolerance in bf16; the same pieces
    added in order, as K7 added them before, miss it."""
    b, hq, hkv, s, d = 3, 10, 2, 1536, 128
    q, k, v = _qkv(b, hq, hkv, s, d, seed=50, decode=True)
    q, k, v = _torch((50 * q, k, v), torch.bfloat16)
    length = torch.tensor([1536, 1000, 700], dtype=torch.int32)
    want = _attention_f64(q, k, v, length=length)
    mask = torch.arange(s)[None, None, :] < length[:, None, None]
    vd = v.double().repeat_interleave(hq // hkv, dim=1)
    scale = float(np.float32(1.0 / math.sqrt(d)))

    def out(raw):
        x = torch.where(mask, (raw * scale).float().double(), -1e30)
        return torch.einsum("bhk,bhkd->bhd", x.softmax(-1), vd).to(q.dtype)
    _assert_close(out(_decode_scores(q, k)), want)
    with pytest.raises(AssertionError):
        _assert_close(out(_decode_scores(q, k, tree=False)), want)


# (B, Hq, Hkv, S, D): ragged lengths, Qwen1.5-0.5B's heads at its prompt,
# Qwen2.5-14B's GQA (40 q heads over 8 KV heads, hd 128), the smoke widths
GPU_FLASH = [(2, 4, 2, 77, 64), (1, 4, 4, 1000, 64), (2, 16, 16, 1024, 64),
             (1, 40, 8, 256, 128), (2, 5, 1, 33, 16), (1, 6, 3, 130, 32)]
# and decode: group 10 takes two blocks of 8 query heads per KV head
GPU_DECODE = [(3, 16, 16, 1536, 64), (3, 40, 8, 1000, 128),
              (3, 20, 2, 77, 64), (3, 5, 1, 40, 16), (3, 8, 8, 513, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", GPU_FLASH)
def test_gpu_flash_attention_matches_plain(cuda, case, causal, dtype):
    q, k, v = _torch(_qkv(*case), DTYPES[dtype], cuda)
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    _assert_close(got, flash_attention_plain(q, k, v, causal=causal))


# Lengths around the edges of K6's 16-row fragments and 64-key tiles.
TILE_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 127, 129]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 24])
@pytest.mark.parametrize("s", TILE_LENGTHS)
def test_gpu_flash_attention_at_tile_edges(cuda, s, d):
    """K6 against its plain version at S around the tile edges, head dims
    64 and 24 (24 pads the tensor cores' depth to 32), GQA groups 1 and 5,
    causal and not, in both types."""
    for hq, hkv in ((5, 5), (5, 1)):
        for dtype in DTYPES.values():
            q, k, v = _torch(_qkv(2, hq, hkv, s, d, seed=s), dtype, cuda)
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                _assert_close(got, flash_attention_plain(q, k, v,
                                                         causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gpu_flash_attention_rescales_large_scores(cuda, dtype):
    """q scaled by 50, so the scores are of magnitude about 50: a row's
    running max rises by tens from key tile to key tile and the
    accumulator is rescaled each time."""
    q, k, v = _qkv(2, 4, 2, 1024, 64, seed=3)
    q, k, v = _torch((50 * q, k, v), DTYPES[dtype], cuda)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _assert_close(got, flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gpu_flash_attention_hd128_large_scores_against_float64(cuda, dtype):
    """The shapes of the test above at head dim 128, q scaled by 50, causal
    and not: held to the same card tolerance against attention computed in
    float64 from the same inputs (``_attention_f64``), not against the
    float32 plain version, whose own sums differ from it by about the 1e-5
    floor on outputs near zero."""
    q, k, v = _qkv(2, 4, 2, 1024, 128, seed=3)
    q, k, v = _torch((50 * q, k, v), DTYPES[dtype], cuda)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = _attention_f64(q, k, v, causal=causal)
        _print_margin(f"K6 {dtype} causal={causal}", got, want)
        _print_margin(f"K6 plain {dtype} causal={causal}",
                      flash_attention_plain(q, k, v, causal=causal), want)
        _assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("ramp", [0.0, 1.0])
def test_gpu_flash_attention_cancelled_rows(cuda, ramp):
    """Outputs that cancel to near zero (v of alternating sign), held to
    the 1e-5 floor of the bf16 tolerance: over equal keys (ramp 0) they
    cancel exactly; over keys whose probabilities differ (ramp 1) one bf16
    P would miss by up to 2^-8·Σ p|v| (see
    test_bf16_flash_needs_p_as_two_bf16_halves), two halves do not."""
    q, k, v = _torch(_cancelling_qkv(2, 4, 2, 1024, 64, ramp=ramp),
                     torch.bfloat16, cuda)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _assert_close(got, flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", GPU_DECODE)
def test_gpu_decode_attention_matches_plain(cuda, case, dtype):
    b, hq, hkv, s, d = case
    q, k, v = _torch(_qkv(*case, decode=True), DTYPES[dtype], cuda)
    for ln in ([0, 1, s], [s + 5, s // 2, -1]):
        length = torch.tensor(ln, dtype=torch.int32, device=cuda)
        before = kernels.LAUNCHES["decode_attention"]
        got = decode_attention(q, k, v, length)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["decode_attention"] == before + 1
        _assert_close(got, decode_attention_plain(q, k, v, length))


@pytest.mark.gpu
def test_gpu_decode_attention_reads_a_cache_layer_view(cuda):
    """The decode path hands the kernel ``ks[layer]``, a view into the
    stacked cache: contiguous, at an offset."""
    q, k, v = _torch(_qkv(2, 8, 4, 96, 64, decode=True), torch.bfloat16, cuda)
    ks = torch.stack([torch.zeros_like(k), k])
    vs = torch.stack([torch.zeros_like(v), v])
    length = torch.tensor([50, 96], dtype=torch.int32, device=cuda)
    got = decode_attention(q, ks[1], vs[1], length)
    _assert_close(got, decode_attention_plain(q, k, v, length))



# --- K7's split on the card ---------------------------------------------------

def _card_plan(cuda, b, hq, hkv, s, d):
    return split_plan(b, hq, hkv, s, d, dec_mod.sm_count(cuda))


def _decode_check(q, k, v, length):
    got = decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    _assert_close(got, decode_attention_plain(q, k, v, length))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [1, 31, 32, 33, "chunk - 1", "chunk",
                               "chunk + 1", 1536])
def test_gpu_decode_split_at_chunk_edges(cuda, s, dtype):
    """S around the tile and the chunk (from the plan at S = 1536), and in
    each call the lengths -1, 0, 1, chunk, chunk + 1, S and S + 5, where
    chunk is the plan's at this S: GQA group 5, hd 64."""
    b, hq, hkv, d = 7, 10, 2, 64
    if isinstance(s, str):
        chunk = _card_plan(cuda, b, hq, hkv, 1536, d)[0]
        s = chunk + {"chunk - 1": -1, "chunk": 0, "chunk + 1": 1}[s]
    chunk = _card_plan(cuda, b, hq, hkv, s, d)[0]
    q, k, v = _torch(_qkv(b, hq, hkv, s, d, seed=s, decode=True),
                     DTYPES[dtype], cuda)
    length = torch.tensor([-1, 0, 1, chunk, chunk + 1, s, s + 5],
                          dtype=torch.int32, device=cuda)
    _decode_check(q, k, v, length)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [24, 64, 96, 128])
@pytest.mark.parametrize("group", [1, 5, 10])
def test_gpu_decode_split_groups_and_head_dims(cuda, group, d, dtype):
    """GQA groups 1, 5 and 10 (10: two head tiles of a KV head) at hd 24,
    64, 96 and 128, over a cache of 1536 split into several chunks."""
    b, hkv, s = 3, 2, 1536
    assert _card_plan(cuda, b, group * hkv, hkv, s, d)[1] > 1
    q, k, v = _torch(_qkv(b, group * hkv, hkv, s, d, seed=d + group,
                          decode=True), DTYPES[dtype], cuda)
    length = torch.tensor([1536, 1025, 100], dtype=torch.int32, device=cuda)
    _decode_check(q, k, v, length)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gpu_decode_split_mostly_empty_cache(cuda, dtype):
    """Length 33 of S 1536 at Qwen1.5-0.5B's served heads: every chunk but
    the first is empty and writes the empty partial."""
    b, hq, hkv, s, d = 8, 16, 16, 1536, 64
    chunk, chunks, _ = _card_plan(cuda, b, hq, hkv, s, d)
    assert chunks > 1 and chunk > 33
    q, k, v = _torch(_qkv(b, hq, hkv, s, d, seed=33, decode=True),
                     DTYPES[dtype], cuda)
    _decode_check(q, k, v, torch.full((b,), 33, dtype=torch.int32,
                                      device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gpu_decode_split_rescales_large_scores(cuda, dtype):
    """q scaled by 50: the chunks' maxima differ by tens, so the combine
    rescales every partial.  Head dim 64, as K6's test of the same: at hd
    128 the scores reach several hundred, and two float32 sums of them in
    different orders (the kernel's, the plain version's, the earlier
    kernel's) already differ by about 1e-5 on outputs near zero, the floor
    of the bf16 tolerance."""
    b, hq, hkv, s, d = 3, 10, 2, 1536, 64
    q, k, v = _qkv(b, hq, hkv, s, d, seed=50, decode=True)
    q, k, v = _torch((50 * q, k, v), DTYPES[dtype], cuda)
    _decode_check(q, k, v, torch.tensor([1536, 1000, 700], dtype=torch.int32,
                                        device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gpu_decode_split_hd128_large_scores_against_float64(cuda, dtype):
    """The shapes and ragged lengths of the test above at head dim 128, q
    scaled by 50, held to the card tolerance against attention computed in
    float64 from the same inputs (``_attention_f64``)."""
    b, hq, hkv, s, d = 3, 10, 2, 1536, 128
    q, k, v = _qkv(b, hq, hkv, s, d, seed=50, decode=True)
    q, k, v = _torch((50 * q, k, v), DTYPES[dtype], cuda)
    length = torch.tensor([1536, 1000, 700], dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    want = _attention_f64(q, k, v, length=length)
    _print_margin(f"K7 {dtype}", got, want)
    _print_margin(f"K7 plain {dtype}",
                  decode_attention_plain(q, k, v, length), want)
    _assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gpu_decode_split_cancelled_rows(cuda, dtype):
    """V of alternating sign over equal keys: every p of a row is equal, so
    an even count of positions cancels to 0 and an odd count leaves v/n;
    held to the 1e-5 floor of the bf16 tolerance across the chunks."""
    b, hq, hkv, s, d = 4, 4, 2, 1536, 64
    q, k, v = _cancelling_qkv(b, hq, hkv, s, d, ramp=0.0)
    q, k, v = _torch((np.ascontiguousarray(q[:, :, 0]), k, v), DTYPES[dtype],
                     cuda)
    _decode_check(q, k, v, torch.tensor([1536, 1025, 1000, 333],
                                        dtype=torch.int32, device=cuda))


@pytest.mark.gpu
def test_gpu_decode_runs_without_host_sync(cuda):
    """The served decode loop runs under sync debug mode "error": K7, its
    plan, workspace and counters (made afresh here, on a new stream) must
    not read anything back to the host."""
    q, k, v = _torch(_qkv(8, 16, 16, 1536, 64, seed=7, decode=True),
                     torch.bfloat16, cuda)
    length = torch.tensor([1025, 1, 0, 1536, 33, 700, 1024, 1535],
                          dtype=torch.int32, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream):
            outs = [decode_attention(q, k, v, length) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, length)
    for got in outs:
        assert bool(torch.isfinite(got.float()).all())
        _assert_close(got, want)


# Every head dim the kernels are built for: the multiples of 8 up to 128,
# Phi-3's 96 and its smoke config's 24 among them (fault F1).
HEAD_DIMS = list(range(8, 129, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_gpu_attention_kernels_at_every_head_dim(cuda, d, dtype):
    """K6 (causal and not) and K7 at each built head dim, against their
    plain versions; S = 77 and a GQA group of 2."""
    q, k, v = _torch(_qkv(2, 4, 2, 77, d, seed=d), DTYPES[dtype], cuda)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _assert_close(got, flash_attention_plain(q, k, v, causal=causal))
    length = torch.tensor([0, 50], dtype=torch.int32, device=cuda)
    got = decode_attention(q[:, :, 0].contiguous(), k, v, length)
    torch.cuda.synchronize()
    _assert_close(got, decode_attention_plain(q[:, :, 0].contiguous(), k, v,
                                              length))


@pytest.mark.gpu
def test_gpu_attention_kernels_say_what_is_built(cuda):
    """``*_supports`` is true exactly for the head dims built, and the
    wrappers refuse any other."""
    from repro_torch.kernels import build
    for name in ("flash_attention", "decode_attention"):
        fn = getattr(build.load(name), f"{name}_supports")
        assert [d for d in range(0, 300) if fn(d)] == HEAD_DIMS
    q, k, v = _torch(_qkv(1, 2, 2, 16, 12), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q[:, :, 0].contiguous(), k, v,
                         torch.ones(1, dtype=torch.int32, device=cuda))

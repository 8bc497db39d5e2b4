"""The port's kernels held against the JAX package's Pallas kernels (run in
interpret mode) and their oracles, bit for bit.

On the CPU each wrapper runs its kernel's plain PyTorch version; the tests
marked ``gpu`` compare the CUDA kernels with those plain versions on the
card and skip without one."""
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import keys
from repro_torch.kernels.segment_min import ops as seg_ops
from repro_torch.kernels.segment_min import ref as seg_ref
from repro_torch.kernels.segment_min.segment_min import (
    segmented_min2_scan, segmented_min2_scan_plain)
from repro_torch.kernels.spmv_minplus import ops as spmv_ops
from repro_torch.kernels.spmv_minplus import ref as spmv_ref
from repro_torch.kernels.spmv_minplus import spmv_minplus
from repro_torch.kernels.spmv_minplus.spmv_minplus import (
    jump_steps, masked_minplus_scan, masked_minplus_scan_plain, pointer_jump,
    pointer_jump_plain)

INF = keys.INF_KEY
BLOCK = 128          # Pallas tile for the interpret-mode runs
SCAN_CASES = ["plain", "ragged", "one_run", "all_inf", "dup_keys", "all_equal"]
JUMP_FORESTS = ["identity", "chain", "hook", "cycle", "beyond"]


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernels, imported for this module only (the
    ``jax.experimental.enable_x64`` name is installed for the import and
    removed again with the ``repro`` modules on teardown)."""
    import jax
    import jax.experimental
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro.kernels.segment_min import ops as so, ref as sr
        from repro.kernels.segment_min import segment_min as sk
        from repro.kernels.spmv_minplus import ops as po, ref as pr
        from repro.kernels.spmv_minplus import spmv_minplus as pk
        yield types.SimpleNamespace(seg_ops=so, seg_ref=sr, seg_kernel=sk,
                                    spmv_ops=po, spmv_ref=pr, spmv_kernel=pk,
                                    enable_x64=jax.experimental.enable_x64)
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
    return torch.device("cuda")


def _scan_case(case: str, seed: int = 0):
    """Sorted int32 segments, other-endpoint labels and flipped int64 keys."""
    rng = np.random.default_rng(seed)
    m = {"ragged": 1000, "one_run": 6 * BLOCK}.get(case, 8 * BLOCK)
    nseg = {"one_run": 1, "ragged": 5}.get(case, 37)
    seg = np.sort(rng.integers(0, nseg, m)).astype(np.int32)
    oth = rng.integers(0, nseg, m).astype(np.int32)
    hi = rng.integers(0, 40, m).astype(np.int64)          # many hi-lane ties
    lo = rng.integers(0, 2 ** 32 - 1, m).astype(np.int64)
    if case == "dup_keys":
        lo = rng.integers(0, 5, m).astype(np.int64)
    if case == "all_equal":
        hi[:] = 0x3F000000
        lo[:] = 7
    key = ((hi << 32) | lo) ^ keys.SIGN
    key[rng.random(m) < 0.1] = INF
    if case == "all_inf":
        key[:] = INF
    return seg, oth, key


def _lanes(key):
    """The reference's (hi, lo) uint32 lanes of the port's keys."""
    u = keys.to_reference(key)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _pad_block(seg, oth, key):
    """Pad to a Pallas tile multiple; padding lanes follow every real lane,
    so they never reach the real lanes of a causal scan."""
    pad = (-seg.shape[0]) % BLOCK
    return (np.concatenate([seg, np.full(pad, 0x7FFFFFF0, np.int32)]),
            np.concatenate([oth, np.full(pad, 0x7FFFFFF0, np.int32)]),
            np.concatenate([key, np.full(pad, INF, np.int64)]))


@pytest.mark.parametrize("case", SCAN_CASES)
def test_segmented_min2_scan_plain_matches_pallas(ref, case):
    import jax.numpy as jnp
    seg, _, key = _scan_case(case)
    m = seg.shape[0]
    got = segmented_min2_scan(torch.from_numpy(seg), torch.from_numpy(key))
    pseg, _, pkey = _pad_block(seg, seg, key)
    hi, lo = _lanes(pkey)
    shi, slo = ref.seg_kernel.segmented_min2_scan(
        jnp.asarray(pseg), jnp.asarray(hi), jnp.asarray(lo), block=BLOCK,
        interpret=True)
    want = keys.from_reference(
        (np.asarray(shi).astype(np.uint64) << np.uint64(32))
        | np.asarray(slo).astype(np.uint64))[:m]
    assert np.array_equal(got.numpy(), want)
    oh, ol = ref.seg_ref.segmented_min2_scan(
        jnp.asarray(seg), jnp.asarray(hi[:m]), jnp.asarray(lo[:m]))
    assert np.array_equal(got.numpy(), keys.from_reference(
        (np.asarray(oh).astype(np.uint64) << np.uint64(32))
        | np.asarray(ol).astype(np.uint64)))
    assert torch.equal(got, seg_ref.segmented_min2_scan(
        torch.from_numpy(seg), torch.from_numpy(key)))


@pytest.mark.parametrize("case", SCAN_CASES)
def test_masked_minplus_scan_plain_matches_pallas(ref, case):
    import jax.numpy as jnp
    seg, oth, key = _scan_case(case, seed=1)
    m = seg.shape[0]
    got = masked_minplus_scan(torch.from_numpy(seg), torch.from_numpy(oth),
                              torch.from_numpy(key))
    pseg, poth, pkey = _pad_block(seg, oth, key)
    hi, lo = _lanes(pkey)
    shi, slo = ref.spmv_kernel.masked_minplus_scan(
        jnp.asarray(pseg), jnp.asarray(poth), jnp.asarray(hi),
        jnp.asarray(lo), block=BLOCK, interpret=True)
    want = keys.from_reference(
        (np.asarray(shi).astype(np.uint64) << np.uint64(32))
        | np.asarray(slo).astype(np.uint64))[:m]
    assert np.array_equal(got.numpy(), want)
    # The masked oracle: mask the lanes, then the unmasked scan oracle.
    inf32 = np.uint32(0xFFFFFFFF)
    live = (seg != oth) & ~((hi[:m] == inf32) & (lo[:m] == inf32))
    oh, ol = ref.seg_ref.segmented_min2_scan(
        jnp.asarray(seg), jnp.asarray(np.where(live, hi[:m], inf32)),
        jnp.asarray(np.where(live, lo[:m], inf32)))
    assert np.array_equal(got.numpy(), keys.from_reference(
        (np.asarray(oh).astype(np.uint64) << np.uint64(32))
        | np.asarray(ol).astype(np.uint64)))


@pytest.mark.parametrize("n", [1, 2, 97, 1024])
def test_pointer_jump_plain_matches_pallas(ref, n):
    import jax.numpy as jnp
    rng = np.random.default_rng(11 + n)
    parent = np.minimum(rng.integers(0, n, n), np.arange(n)).astype(np.int32)
    if n > 2:
        parent[n // 2:] = np.arange(n // 2 - 1, n - 1)   # one deep chain
    comp = rng.integers(0, n, n).astype(np.int32)
    got = pointer_jump(torch.from_numpy(parent), torch.from_numpy(comp))
    want = ref.spmv_kernel.pointer_jump(jnp.asarray(parent.astype(np.uint32)),
                                        jnp.asarray(comp.astype(np.uint32)),
                                        interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    oracle = ref.spmv_ref.shortcut_relabel(jnp.asarray(parent),
                                           jnp.asarray(comp))
    assert np.array_equal(got.numpy(), np.asarray(oracle))
    assert torch.equal(got, spmv_ref.shortcut_relabel(
        torch.from_numpy(parent), torch.from_numpy(comp)))


def _jump_forest(kind: str, n: int, seed: int = 0):
    """int32 (parent, comp), n labels each: the identity forest, a deep
    chain, a random hook forest (parent[i] <= i), the cycle i -> i + 1
    (mod n), which no doubling step leaves unchanged before the last, or
    labels >= n (up to 2**31 - 1), which break the hook contract and which
    the clip maps to n - 1."""
    rng = np.random.default_rng(seed + n)
    ids = np.arange(n)
    comp = rng.integers(0, n, n)
    if kind == "identity":
        parent = ids
    elif kind == "chain":
        parent = np.maximum(ids - 1, 0)
    elif kind == "hook":
        parent = np.minimum(rng.integers(0, n, n), ids)
    elif kind == "cycle":
        parent = (ids + 1) % n
    elif kind == "beyond":
        parent = rng.integers(0, 2 * n + 3, n)
        parent[rng.random(n) < 0.1] = 2 ** 31 - 1
        comp = rng.integers(0, 2 * n + 3, n)
        comp[rng.random(n) < 0.1] = 2 ** 31 - 1
    else:
        raise ValueError(kind)
    return parent.astype(np.int32), comp.astype(np.int32)


def _jump_schedule(parent: np.ndarray, comp: np.ndarray):
    """A model of K3's schedule (``csrc/pointer_jump.cu``): doubling steps
    from one buffer to the other, leaving at the first step that changes no
    label or after ``jump_steps(n)``, then the relabel.  Returns the labels
    and the steps run."""
    n = parent.shape[0]
    src = parent
    for steps in range(1, jump_steps(n) + 1):
        dst = src[np.clip(src, 0, n - 1)]
        changed = bool((dst != src).any())
        src = dst
        if not changed:
            break
    return src[np.clip(comp, 0, n - 1)], steps


@pytest.mark.parametrize("kind", JUMP_FORESTS)
@pytest.mark.parametrize("n", [1, 2, 97, 1024])
def test_jump_schedule_matches_pallas(ref, n, kind):
    """The early exit is exact: the model of the kernel's schedule equals
    the Pallas function's fixed ⌈log2 n⌉ steps, and the plain version, on
    hook forests and on inputs that break the hook contract."""
    import jax.numpy as jnp
    parent, comp = _jump_forest(kind, n)
    got, steps = _jump_schedule(parent, comp)
    want = ref.spmv_kernel.pointer_jump(jnp.asarray(parent.astype(np.uint32)),
                                        jnp.asarray(comp.astype(np.uint32)),
                                        interpret=True)
    assert np.array_equal(got, np.asarray(want).astype(np.int32))
    assert np.array_equal(got, pointer_jump_plain(
        torch.from_numpy(parent), torch.from_numpy(comp)).numpy())
    assert 1 <= steps <= jump_steps(n)
    if kind == "identity":
        assert steps == 1
    if kind == "cycle":
        assert steps == jump_steps(n)


def _election_case(rng, *, all_equal=False, dup_keys=False, ragged=False):
    """CSR-shaped election layout (a copy of the JAX package's test
    generator): endpoint fragment labels + packed reference keys, with dead
    edges, INF padding lanes, optional duplicate keys / all-equal weights /
    skewed segment sizes."""
    n = int(rng.integers(1, 50))
    m = int(rng.integers(0, 300))
    cs = rng.integers(0, n, m).astype(np.uint32)
    cd = rng.integers(0, n, m).astype(np.uint32)
    if ragged and m:
        cs[: m // 2] = rng.integers(0, max(n // 8, 1), m // 2)
    if all_equal:
        wbits = np.full(m, 0x3F000000, np.uint64)
    else:
        wbits = rng.integers(0, 1 << 29, m).astype(np.uint64)
    eid = np.arange(m, dtype=np.uint64)
    if dup_keys and m:
        eid = rng.integers(0, max(m // 3, 1), m).astype(np.uint64)
    key = (wbits << np.uint64(32)) | eid
    if m:
        key[rng.random(m) < 0.15] = np.uint64(0xFFFFFFFFFFFFFFFF)
        dead = rng.random(m) < 0.2
        cd[dead] = cs[dead]
    return n, cs, cd, key


@pytest.mark.parametrize("case", ["plain", "ragged", "dup_keys", "all_equal"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elect_lowerings_match_reference(ref, case, seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(1000 * seed + len(case))
    n, cs, cd, key = _election_case(
        rng, all_equal=(case == "all_equal"), dup_keys=(case == "dup_keys"),
        ragged=(case == "ragged"))
    m = key.shape[0]
    with ref.enable_x64():
        args = (jnp.asarray(cs), jnp.asarray(cd), jnp.asarray(key))
        want = np.asarray(ref.spmv_ops.elect(*args, num_segments=n,
                                             lowering="scatter"))
        want_k = np.asarray(ref.spmv_ops.elect(*args, num_segments=n,
                                               lowering="pallas", block=BLOCK))
    assert np.array_equal(want, want_k)
    sort_bits = spmv_ops.sort_gate(n, max(m, 1))
    assert sort_bits == ref.spmv_ops.sort_gate(n, max(m, 1))
    tcs = torch.from_numpy(cs.astype(np.int32))
    tcd = torch.from_numpy(cd.astype(np.int32))
    tkey = torch.from_numpy(keys.from_reference(key))
    for lowering in spmv_ops.ELECT_LOWERINGS:
        got = spmv_ops.elect(tcs, tcd, tkey, num_segments=n, lowering=lowering,
                             sort_bits=sort_bits)
        assert np.array_equal(keys.to_reference(got), want), lowering


def test_sort_lowering_uses_all_64_bits():
    """A sort word with its top bit set (s + 30 + c == 64) still sorts in
    unsigned order: the high fragments elect the same edges as scatter."""
    n, m = 1 << 17, 1 << 17
    assert spmv_ops.sort_gate(n, m) == (17, 17)
    rng = np.random.default_rng(5)
    e = 4096
    cs = torch.from_numpy(rng.integers(n - 64, n, e).astype(np.int32))
    cd = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    w = rng.random(e, dtype=np.float32) * np.float32(0.99) + np.float32(0.005)
    key = torch.from_numpy(keys.pack_keys_np(w, rng.permutation(m)[:e]))
    want = spmv_ops.elect(cs, cd, key, num_segments=n, lowering="scatter")
    got = spmv_ops.elect(cs, cd, key, num_segments=n, lowering="sort",
                         sort_bits=(17, 17))
    assert torch.equal(got, want)
    assert (want[n - 64:] != INF).any()


@pytest.mark.parametrize("m,s", [(0, 4), (5, 0), (1, 1), (700, 9)])
def test_segment_min64_paths_match_reference(ref, m, s):
    import jax.numpy as jnp
    rng = np.random.default_rng(m + s)
    seg = rng.integers(0, max(s, 1), m).astype(np.int32)
    key = ((rng.integers(0, 2 ** 31, m).astype(np.uint64) << np.uint64(32))
           | rng.integers(0, 2 ** 32 - 1, m).astype(np.uint64))
    with ref.enable_x64():
        want = np.asarray(ref.seg_ref.segment_min64(
            jnp.asarray(key), jnp.asarray(seg), s))
    for use_pallas in (False, True):
        got = seg_ops.segment_min64(torch.from_numpy(keys.from_reference(key)),
                                    torch.from_numpy(seg), num_segments=s,
                                    use_pallas=use_pallas)
        assert np.array_equal(keys.to_reference(got), want), use_pallas


def test_cpu_wrappers_launch_nothing():
    kernels.reset_launches()
    seg, oth, key = _scan_case("plain")
    segmented_min2_scan(torch.from_numpy(seg), torch.from_numpy(key))
    masked_minplus_scan(torch.from_numpy(seg), torch.from_numpy(oth),
                        torch.from_numpy(key))
    pointer_jump(torch.zeros(4, dtype=torch.int32),
                 torch.zeros(4, dtype=torch.int32))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(TypeError):
        segmented_min2_scan(torch.from_numpy(seg).long(), torch.from_numpy(key))
    with pytest.raises(ValueError):
        pointer_jump(torch.zeros(4, dtype=torch.int64),
                     torch.zeros(4, dtype=torch.int32))


# --- on the card -----------------------------------------------------------

def _gpu_scan_inputs(case, device):
    g = torch.Generator(device="cpu").manual_seed(3)
    m = {"tiny": 5, "one_tile": 2048, "ragged": 2048 * 3 + 17,
         "many_tiles": 2048 * 1100 + 37, "one_run": 2048 * 40}[case]
    nseg = {"one_run": 1, "many_tiles": 50_000}.get(case, 7)
    seg = torch.sort(torch.randint(0, nseg, (m,), generator=g)).values
    oth = torch.randint(0, nseg, (m,), generator=g)
    key = torch.randint(-2 ** 62, 2 ** 62, (m,), generator=g)
    key[torch.rand(m, generator=g) < 0.1] = INF
    return (seg.to(torch.int32).to(device), oth.to(torch.int32).to(device),
            key.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tiny", "one_tile", "ragged", "many_tiles",
                                  "one_run"])
def test_gpu_scan_kernels_match_plain(cuda, case):
    seg, oth, key = _gpu_scan_inputs(case, cuda)
    kernels.reset_launches()
    got = segmented_min2_scan(seg, key)
    got_m = masked_minplus_scan(seg, oth, key)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["segmented_min2_scan"] == 1
    assert kernels.LAUNCHES["masked_minplus_scan"] == 1
    assert torch.equal(got, segmented_min2_scan_plain(seg, key))
    assert torch.equal(got_m, masked_minplus_scan_plain(seg, oth, key))
    inf_key = torch.full_like(key, INF)
    assert torch.equal(segmented_min2_scan(seg, inf_key), inf_key)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", JUMP_FORESTS)
@pytest.mark.parametrize("n", [1, 97, 1 << 20, (1 << 20) + 12345, 1 << 22])
def test_gpu_pointer_jump_matches_plain(cuda, n, kind):
    """K3 equals its plain version bit for bit, with comp of n labels, of
    fewer and of more; one launch a call."""
    parent, comp = (torch.from_numpy(a).to(cuda)
                    for a in _jump_forest(kind, n, seed=n))
    comps = [comp, comp[: n // 3 + 1].contiguous(),
             torch.cat([comp, comp.flip(0), comp[:1]])]
    kernels.reset_launches()
    got = [pointer_jump(parent, c) for c in comps]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pointer_jump"] == len(comps)
    for g, c in zip(got, comps):
        assert torch.equal(g, pointer_jump_plain(parent, c))


@pytest.mark.gpu
def test_gpu_pointer_jump_back_to_back(cuda):
    """Three calls queued on one stream, each on another forest (the cycle
    runs every step, the identity one), each equal to its plain result; the
    step flags are back at 0 after them."""
    n = (1 << 20) + 12345
    cases = [tuple(torch.from_numpy(a).to(cuda)
                   for a in _jump_forest(kind, n, seed=7))
             for kind in ("cycle", "identity", "hook")]
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = [pointer_jump(p, c) for p, c in cases]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pointer_jump"] == 3
    for g, (p, c) in zip(got, cases):
        assert torch.equal(g, pointer_jump_plain(p, c))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not spmv_minplus._jump_flags[(got[0].device.index, stream)].any()


@pytest.mark.gpu
def test_gpu_pointer_jump_on_a_side_stream(cuda):
    parent, comp = (torch.from_numpy(a).to(cuda)
                    for a in _jump_forest("chain", 1 << 20))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    kernels.reset_launches()
    with torch.cuda.stream(side):
        got = pointer_jump(parent, comp)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pointer_jump"] == 1
    assert torch.equal(got, pointer_jump_plain(parent, comp))
    assert not spmv_minplus._jump_flags[(got.device.index,
                                         side.cuda_stream)].any()


@pytest.mark.gpu
@pytest.mark.parametrize("round_kernel", ["xla", "pallas"])
def test_gpu_intervals_never_wait_for_the_device(cuda, round_kernel,
                                                 monkeypatch):
    """Queuing an interval (and compacting) makes no synchronizing call:
    the host waits only at the interval's one readback."""
    from repro_torch.core import generators, mst_api, runtime
    from repro_torch.core.params import GHSParams
    loop = runtime.interval_loop

    def strict(fn):
        def run(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    def checked(state, dispatch, finish, **kw):
        return loop(state, strict(dispatch), strict(finish), **kw)

    monkeypatch.setattr(runtime, "interval_loop", checked)
    g = generators.rmat(12, seed=3)
    params = GHSParams(round_kernel=round_kernel, use_pallas=True,
                       check_frequency=2)
    mst_api.minimum_spanning_forest(g, params=params)


@pytest.mark.gpu
@pytest.mark.parametrize("round_kernel", ["xla", "pallas"])
def test_gpu_solve_matches_cpu(cuda, round_kernel):
    from repro_torch.core import generators, kruskal_ref, mst_api
    from repro_torch.core.params import GHSParams
    g = generators.rmat(10, seed=7)
    params = GHSParams(round_kernel=round_kernel, use_pallas=True)
    kernels.reset_launches()
    got, st = mst_api.minimum_spanning_forest(g, params=params)
    assert sum(kernels.LAUNCHES.values()) > 0
    want, wst = mst_api.minimum_spanning_forest(g, params=params, device="cpu")
    assert np.array_equal(got.edge_mask, kruskal_ref.kruskal(g).edge_mask)
    assert np.array_equal(got.edge_mask, want.edge_mask)
    assert (st.rounds, st.intervals, st.host_syncs, st.compactions,
            st.active_history) == (wst.rounds, wst.intervals, wst.host_syncs,
                                   wst.compactions, wst.active_history)

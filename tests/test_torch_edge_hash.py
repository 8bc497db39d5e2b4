"""The port's edge hash — ``hash_slot``, the host build and the batched
lookup kernel (K5) — held against the JAX package's, bit for bit: the
Pallas kernel runs in interpret mode.

On the CPU the lookup wrapper runs its plain PyTorch version; the tests
marked ``gpu`` compare the CUDA kernel with it on the card and skip
without one."""
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import ghs_state
from repro_torch.kernels.edge_hash import ops, ref as hash_ref
from repro_torch.kernels.edge_hash.edge_hash import (
    hash_lookup, hash_lookup_plain)

RNG_SEED = 0
EDGE_VALUES = np.array([0, 1, 2, 0x7FFF, 0x10000, 0x7FFFFFFE, 0x7FFFFFFF,
                        -0x80000000, -0x7FFFFFFF, -2, -1], np.int32)


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's edge hash, imported for this module only (the
    ``jax.experimental.enable_x64`` name is installed for the import and
    removed again with the ``repro`` modules on teardown)."""
    import jax
    import jax.experimental
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro.core import ghs_state as rgs
        from repro.kernels.edge_hash import edge_hash as rk
        from repro.kernels.edge_hash import ops as ro, ref as rr
        yield types.SimpleNamespace(ghs_state=rgs, kernel=rk, ops=ro, ref=rr)
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


def _sweep_table(n: int, seed: int = RNG_SEED):
    """Distinct (lv, u) pairs and their table, as the JAX package's
    ``tests/test_kernels.py`` edge-hash sweep builds them; queries are the
    pairs (hits) and the pairs with the receiver shifted (misses)."""
    rng = np.random.default_rng(seed)
    lv = rng.integers(0, 997, n).astype(np.int32)
    u = rng.integers(0, 99991, n).astype(np.int32)
    pairs = sorted({(a, b) for a, b in zip(lv, u)})
    lv = np.array([p[0] for p in pairs], np.int32)
    u = np.array([p[1] for p in pairs], np.int32)
    pos = np.arange(len(lv), dtype=np.int32)
    tsize = int(len(lv) * 4.23) | 1
    q_lv = np.concatenate([lv, lv + 7919])
    q_u = np.concatenate([u, u])
    d = {(a, b): p for a, b, p in zip(lv, u, pos)}
    want = np.array([d.get((a, b), -1) for a, b in zip(q_lv, q_u)], np.int32)
    return (lv, u, pos, tsize), (q_lv, q_u), want


def _chain_table(length: int, tsize: int, home: int):
    """``length`` distinct pairs that all hash to slot ``home``: one probe
    chain of that length (wrapping past the end when ``home`` is late)."""
    lv, u = hash_ref.colliding_pairs(length, tsize, home)
    assert lv.size == length
    return lv, u, np.arange(length, dtype=np.int32) + 100


def _lookup_all(ref, table, q_lv, q_u, max_probes):
    """The Pallas kernel (interpret mode) and the reference oracle."""
    import jax.numpy as jnp
    args = [jnp.asarray(t) for t in table] + [jnp.asarray(q_lv),
                                              jnp.asarray(q_u)]
    pallas = np.asarray(ref.kernel.hash_lookup(*args, max_probes=max_probes,
                                               interpret=True))
    oracle = np.asarray(ref.ref.hash_lookup(*args, max_probes=max_probes))
    assert np.array_equal(pallas, oracle)
    return pallas


def test_hash_slot_matches_numpy_uint32(ref):
    lv = np.repeat(EDGE_VALUES, EDGE_VALUES.size)
    u = np.tile(EDGE_VALUES, EDGE_VALUES.size)
    rng = np.random.default_rng(3)
    lv = np.concatenate([lv, rng.integers(-2 ** 31, 2 ** 31, 4096,
                                          dtype=np.int64).astype(np.int32)])
    u = np.concatenate([u, rng.integers(-2 ** 31, 2 ** 31, 4096,
                                        dtype=np.int64).astype(np.int32)])
    mixed = ((lv.astype(np.uint32) * ghs_state.HASH_K1)
             ^ (u.astype(np.uint32) * ghs_state.HASH_K2))
    assert np.array_equal(
        ghs_state.mix32(torch.from_numpy(lv), torch.from_numpy(u)).numpy(),
        mixed.astype(np.int64))
    for tsize in (1, 64, 257, 4099, 133_000_001, 2 ** 31 - 1):
        want = ref.ghs_state.hash_slot(lv, u, tsize)
        got = ghs_state.hash_slot(torch.from_numpy(lv), torch.from_numpy(u),
                                  tsize)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), tsize
        assert np.array_equal(ghs_state.hash_slot(lv, u, tsize), want)


@pytest.mark.parametrize("n", [100, 5000])
def test_build_table_byte_equal(ref, n):
    (lv, u, pos, tsize), _, _ = _sweep_table(n)
    got = ops.build_table(lv, u, pos, tsize)
    want = ref.ops.build_table(lv, u, pos, tsize)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("n", [100, 5000])
def test_lookup_plain_matches_pallas(ref, n):
    (lv, u, pos, tsize), (q_lv, q_u), want = _sweep_table(n)
    table = ops.build_table(lv, u, pos, tsize)
    pallas = _lookup_all(ref, table, q_lv, q_u, 64)
    assert np.array_equal(pallas, want)
    kernels.reset_launches()
    for use_pallas in (True, False):
        got = ops.lookup(table, q_lv, q_u, use_pallas=use_pallas,
                         device="cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), use_pallas
    assert kernels.LAUNCHES["hash_lookup"] == 0


@pytest.mark.parametrize("tsize,home", [(1021, 17), (1021, 1010), (64, 60)])
def test_lookup_long_chain(ref, tsize, home):
    """A probe chain longer than ``max_probes``: its late keys are
    unresolved (-1) within 64 probes and found within 128; the chain may
    wrap past the end of the table."""
    length = 60 if tsize == 64 else 100
    lv, u, pos = _chain_table(length, tsize, home)
    table = ops.build_table(lv, u, pos, tsize)
    assert table[2][(home + length - 1) % tsize] == pos[-1]
    q_lv = np.concatenate([lv, [5, -1, -1, 0]]).astype(np.int32)
    q_u = np.concatenate([u, [0, -1, 7, -1]]).astype(np.int32)
    tt = [torch.from_numpy(t) for t in table]
    for max_probes in (64, 128):
        want = _lookup_all(ref, table, q_lv, q_u, max_probes)
        got = hash_lookup(*tt, torch.from_numpy(q_lv), torch.from_numpy(q_u),
                          max_probes=max_probes)
        assert np.array_equal(got.numpy(), want), max_probes
        found = want[:length] >= 0
        expect = np.arange(length) < max_probes
        assert np.array_equal(found, expect)


def test_probe_counts():
    lv, u, pos = _chain_table(10, 257, 250)
    table = [torch.from_numpy(t) for t in ops.build_table(lv, u, pos, 257)]
    q_lv = torch.from_numpy(np.concatenate([lv, [5]]).astype(np.int32))
    q_u = torch.from_numpy(np.concatenate([u, [0]]).astype(np.int32))
    counts = hash_ref.probe_counts(*table, q_lv, q_u, max_probes=64)
    home = int(ghs_state.hash_slot(q_lv[-1:], q_u[-1:], 257)[0])
    # The i-th chained key is found on probe i + 1; the miss stops at the
    # first empty slot after its home.
    h_pos = table[2].numpy()
    empty = next(k for k in range(257) if h_pos[(home + k) % 257] < 0)
    assert counts.tolist() == list(range(1, 11)) + [empty + 1]
    assert hash_ref.probe_counts(*table, q_lv, q_u, max_probes=4).max() == 4


def _traffic_by_query(table, q_lv, q_u, max_probes):
    """``probe_traffic``'s counts, one query at a time in plain Python."""
    h_lv, h_u, h_pos = (t.tolist() for t in table)
    tsize, w = len(h_lv), hash_ref.SECTOR_WORDS
    homes = ghs_state.hash_slot(q_lv, q_u, tsize).tolist()
    out = dict(probes=0, u_reads=0, chain_lv=0, chain_u=0)
    seen_lv, seen_u = set(), set()
    for a, b, idx in zip(q_lv.tolist(), q_u.tolist(), homes):
        last_lv = last_u = None
        for _ in range(max_probes):
            out["probes"] += 1
            out["chain_lv"] += idx // w != last_lv
            last_lv = idx // w
            seen_lv.add(idx // w)
            if h_lv[idx] == a:
                out["u_reads"] += 1
                out["chain_u"] += idx // w != last_u
                last_u = idx // w
                seen_u.add(idx // w)
                if h_u[idx] == b:
                    break
            if h_pos[idx] < 0:
                break
            idx = (idx + 1) % tsize
    out.update(union_lv=len(seen_lv), union_u=len(seen_u))
    return out


@pytest.mark.parametrize("case", ["sweep", "chain"])
def test_probe_traffic(case):
    if case == "sweep":
        (lv, u, pos, tsize), (q_lv, q_u), _ = _sweep_table(300)
    else:
        lv, u, pos = _chain_table(30, 257, 250)
        tsize = 257
        q_lv = np.concatenate([lv, [5, -1]]).astype(np.int32)
        q_u = np.concatenate([u, [0, -1]]).astype(np.int32)
    table = [torch.from_numpy(t) for t in ops.build_table(lv, u, pos, tsize)]
    ql, qu = torch.from_numpy(q_lv), torch.from_numpy(q_u)
    for max_probes in (4, 64):
        got = hash_ref.probe_traffic(*table, ql, qu, max_probes=max_probes)
        assert got == _traffic_by_query(table, ql, qu, max_probes)
        assert got["probes"] == int(hash_ref.probe_counts(
            *table, ql, qu, max_probes=max_probes).sum())
        assert got["union_lv"] <= got["chain_lv"] <= got["probes"]
        assert got["union_u"] <= got["chain_u"] <= got["u_reads"]


def test_lookup_checks_its_inputs():
    t = [torch.full((8,), -1, dtype=torch.int32) for _ in range(3)]
    q = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        hash_lookup(*t, q.long(), q)
    with pytest.raises(ValueError):
        hash_lookup(t[0][:0], t[1][:0], t[2][:0], q, q)
    assert hash_lookup(*t, q, q).tolist() == [-1, -1, -1]


# --- on the card -----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [100, 200_000])
def test_gpu_hash_lookup_matches_plain(cuda, n):
    (lv, u, pos, tsize), (q_lv, q_u), want = _sweep_table(n, seed=n)
    table = ops.build_table(lv, u, pos, tsize)
    kernels.reset_launches()
    got = ops.lookup(table, q_lv, q_u, use_pallas=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hash_lookup"] == 1
    assert np.array_equal(got.cpu().numpy(), want)
    dev = [torch.from_numpy(t).to(cuda) for t in table]
    qd = torch.from_numpy(q_lv).to(cuda), torch.from_numpy(q_u).to(cuda)
    assert torch.equal(got, hash_lookup_plain(*dev, *qd))


@pytest.mark.gpu
def test_gpu_hash_lookup_long_chain(cuda):
    lv, u, pos = _chain_table(100, 1021, 1010)
    table = [torch.from_numpy(t).to(cuda)
             for t in ops.build_table(lv, u, pos, 1021)]
    q_lv = torch.from_numpy(np.concatenate([lv, [-1, 5]]).astype(np.int32))
    q_u = torch.from_numpy(np.concatenate([u, [-1, 0]]).astype(np.int32))
    q_lv, q_u = q_lv.to(cuda), q_u.to(cuda)
    for max_probes in (0, 1, 64, 128):
        got = hash_lookup(*table, q_lv, q_u, max_probes=max_probes)
        assert torch.equal(got, hash_lookup_plain(*table, q_lv, q_u,
                                                  max_probes=max_probes))

"""The port's edge hash — ``hash_slot``, the host build, the pack into
16-byte records and the batched lookup kernel (K5) — held against the JAX
package's, bit for bit: the Pallas kernel runs in interpret mode.

On the CPU both lookup entries (the three arrays, and the packed records)
run the plain PyTorch version; the tests marked ``gpu`` compare the CUDA
kernel with it on the card and skip without one."""
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import ghs_state
from repro_torch.kernels.edge_hash import ops, ref as hash_ref
from repro_torch.kernels.edge_hash.edge_hash import (
    hash_lookup, hash_lookup_plain, hash_lookup_records, pack_records)

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


def _tables():
    """Every table the record tests take: the sweeps of 100 and 5000 pairs
    and ``ref.edge_cases`` (a chain longer than 64 probes, a wrap-around, a
    table of 64 slots, queries of -1).  ``{name: (table, q_lv, q_u)}``,
    numpy int32."""
    out = {}
    for n in (100, 5000):
        (lv, u, pos, tsize), (q_lv, q_u), _ = _sweep_table(n)
        out[f"sweep {n}"] = (ops.build_table(lv, u, pos, tsize), q_lv, q_u)
    for name, (h_lv, h_u, h_pos, q_lv, q_u) in hash_ref.edge_cases(RNG_SEED):
        out[name] = ((h_lv, h_u, h_pos), q_lv, q_u)
    return out


TABLES = list(_tables())


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
    packed = ops.pack_table(table, device="cpu")
    for use_pallas in (True, False):
        for t in (table, packed):
            got = ops.lookup(t, q_lv, q_u, use_pallas=use_pallas,
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


@pytest.mark.parametrize("name", TABLES)
def test_pack_round_trips(name):
    """``ref.pack`` gives contiguous (T, 4) int32 records (lv, u, pos, 0),
    an empty slot (-1, -1, -1, 0); ``ref.unpack``, ``pack_records`` and
    ``ops.pack_table`` agree with it."""
    table, _, _ = _tables()[name]
    tt = [torch.from_numpy(t) for t in table]
    rec = hash_ref.pack(*tt)
    assert rec.shape == (table[0].size, hash_ref.RECORD_WORDS)
    assert rec.dtype == torch.int32 and rec.is_contiguous()
    assert not rec[:, 3].any()
    empty = rec[:, 2] < 0
    assert bool(empty.any()) and bool((rec[empty, :3] == -1).all())
    for got, want in zip(hash_ref.unpack(rec), tt):
        assert got.is_contiguous() and torch.equal(got, want)
    assert torch.equal(ops.pack_table(table, device="cpu"), rec)
    assert torch.equal(pack_records(*tt), rec)
    assert rec.numpy().tobytes() == np.stack(
        [*table, np.zeros_like(table[0])], 1).tobytes()


@pytest.mark.parametrize("name", TABLES)
def test_lookup_records_matches_pallas(ref, name):
    """The records entry on the CPU (unpack, then the plain probe) and the
    three-array entry against the Pallas kernel in interpret mode."""
    table, q_lv, q_u = _tables()[name]
    rec = ops.pack_table(table, device="cpu")
    ql, qu = torch.from_numpy(q_lv), torch.from_numpy(q_u)
    tt = [torch.from_numpy(t) for t in table]
    for max_probes in (0, 1, 64, 128):
        want = _lookup_all(ref, table, q_lv, q_u, max_probes)
        got = hash_lookup_records(rec, ql, qu, max_probes=max_probes)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), max_probes
        assert np.array_equal(hash_lookup(*tt, ql, qu,
                                          max_probes=max_probes).numpy(),
                              want), max_probes


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
    wr = 32 // (4 * hash_ref.RECORD_WORDS)       # records a 32-byte sector
    homes = ghs_state.hash_slot(q_lv, q_u, tsize).tolist()
    out = dict(probes=0, u_reads=0, chain_lv=0, chain_u=0, chain_rec=0)
    seen_lv, seen_u, seen_rec = set(), set(), set()
    for a, b, idx in zip(q_lv.tolist(), q_u.tolist(), homes):
        last_lv = last_u = last_rec = None
        for _ in range(max_probes):
            out["probes"] += 1
            out["chain_lv"] += idx // w != last_lv
            last_lv = idx // w
            seen_lv.add(idx // w)
            out["chain_rec"] += idx // wr != last_rec
            last_rec = idx // wr
            seen_rec.add(idx // wr)
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
    out.update(union_lv=len(seen_lv), union_u=len(seen_u),
               union_rec=len(seen_rec))
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
        assert got["union_rec"] <= got["chain_rec"] <= got["probes"]
        assert got["chain_lv"] <= got["chain_rec"]


def test_lookup_checks_its_inputs():
    t = [torch.full((8,), -1, dtype=torch.int32) for _ in range(3)]
    q = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        hash_lookup(*t, q.long(), q)
    with pytest.raises(ValueError):
        hash_lookup(t[0][:0], t[1][:0], t[2][:0], q, q)
    assert hash_lookup(*t, q, q).tolist() == [-1, -1, -1]
    rec = hash_ref.pack(*t)
    assert hash_lookup_records(rec, q, q).tolist() == [-1, -1, -1]
    for bad in (rec[:, :3], rec.t(), rec.long(), rec[:0]):
        with pytest.raises(ValueError, match="records|empty"):
            hash_lookup_records(bad, q, q)
    with pytest.raises(ValueError):
        hash_lookup_records(rec, q.long(), q)
    with pytest.raises(RuntimeError, match="no kernel"):
        hash_lookup_records(rec.to("meta"), q.to("meta"), q.to("meta"))


def test_pack_records_checks_its_inputs():
    t = [torch.full((8,), -1, dtype=torch.int32) for _ in range(3)]
    for bad in ((t[0].long(), t[1], t[2]), (t[0], t[1][:7], t[2]),
                (t[0], t[1], torch.zeros(4, 2, dtype=torch.int32)[:, 0])):
        with pytest.raises(ValueError, match="pack_records"):
            pack_records(*bad)
    with pytest.raises(RuntimeError, match="no kernel"):
        pack_records(*(x.to("meta") for x in t))


def test_ptxas_report_of_a_plain_kernel():
    """``build.ptxas_resources`` reads K5's kernel, which is no template,
    as ``(0, "")``, and no other kernel whose name ends in its name."""
    from repro_torch.kernels import build
    report = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114records_kernelEPK4int4PKiS4_Pixji' for "
        "'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_114records_kernelEPK4int4PKiS4_Pixji",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 18 registers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117my_records_kernelEPKi' for 'sm_90a'",
        "ptxas info    : Used 99 registers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111scan_kernelILi16EfEEvPKT0_' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 64 registers, 20480 bytes smem"])
    assert build.ptxas_resources(report, "records_kernel") == {
        (0, ""): dict(stack_bytes=0, spill_bytes=0, registers=18)}
    assert build.ptxas_resources(report, "scan_kernel") == {
        (16, "f32"): dict(stack_bytes=8, spill_bytes=8, registers=64,
                          smem_bytes=20480)}


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
@pytest.mark.parametrize("name", TABLES)
def test_gpu_hash_lookup_edge_cases(cuda, name):
    """The records entry and the three-array entry (which packs on the
    card) against the plain version, max_probes 0, 1, 64 and 128; one
    launch each."""
    table, q_lv, q_u = _tables()[name]
    dev = [torch.from_numpy(t).to(cuda) for t in table]
    rec = ops.pack_table(table, device=cuda)
    ql, qu = torch.from_numpy(q_lv).to(cuda), torch.from_numpy(q_u).to(cuda)
    for max_probes in (0, 1, 64, 128):
        want = hash_lookup_plain(*dev, ql, qu, max_probes=max_probes)
        before = kernels.LAUNCHES["hash_lookup"]
        got = hash_lookup_records(rec, ql, qu, max_probes=max_probes)
        three = hash_lookup(*dev, ql, qu, max_probes=max_probes)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["hash_lookup"] == before + 2
        assert torch.equal(got, want), max_probes
        assert torch.equal(three, want), max_probes


@pytest.mark.gpu
@pytest.mark.parametrize("name", TABLES)
def test_gpu_pack_records_matches_ref_pack(cuda, name):
    """The pack kernel gives ``ref.pack``'s records byte for byte and
    counts no lookup launch."""
    table, _, _ = _tables()[name]
    dev = [torch.from_numpy(t).to(cuda) for t in table]
    before = dict(kernels.LAUNCHES)
    rec = pack_records(*dev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before
    assert rec.data_ptr() % 16 == 0
    assert torch.equal(rec, hash_ref.pack(*dev))


@pytest.mark.gpu
def test_gpu_hash_lookup_refuses_misaligned_records(cuda):
    rec = hash_ref.pack(*[torch.full((9,), -1, dtype=torch.int32,
                                     device=cuda) for _ in range(3)])
    q = torch.zeros(3, dtype=torch.int32, device=cuda)
    flat = torch.empty(4 * 9 + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view(9, 4)
    shifted.copy_(rec)
    with pytest.raises(ValueError, match="aligned"):
        hash_lookup_records(shifted, q, q)
    assert hash_lookup_records(rec, q, q).tolist() == [-1, -1, -1]


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

"""The port's foundations held against the JAX package: generators, packed
keys, oracles, partitioners, hooking, runtime — plus import isolation and
the no-CPU-fallback rule of the entry point."""
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (generators, graph as graph_lib, keys,
                              kruskal_ref, mst_api, partition, runtime,
                              union_find)
from repro_torch.core.params import GHSParams

KINDS = ["rmat", "ssca2", "random", "disconnected"]


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package, imported for this module only.  Under the installed
    jax it imports only with ``jax.experimental.enable_x64`` present, so the
    name is installed here and removed again, and the ``repro`` modules are
    dropped from ``sys.modules`` on teardown: other test files in the same
    worker see jax and ``repro`` exactly as before."""
    import jax
    import jax.experimental
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro.core import (generators as g, graph as gr, keys as k,
                                kruskal_ref as kr, partition as p,
                                union_find as uf)
        yield types.SimpleNamespace(generators=g, graph=gr, keys=k,
                                    kruskal_ref=kr, partition=p,
                                    union_find=uf,
                                    enable_x64=jax.experimental.enable_x64)
    finally:
        if shimmed:
            del jax.experimental.enable_x64
        for name in _repro_modules():
            del sys.modules[name]
        sys.modules.update(saved)


@pytest.mark.parametrize("kind", KINDS)
def test_generated_graphs_byte_equal(ref, kind):
    want = ref.generators.generate(kind, 7, seed=5)
    got = generators.generate(kind, 7, seed=5)
    assert got.num_vertices == want.num_vertices
    for field in ("src", "dst", "weight"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert keys.to_reference(got.packed_keys).tobytes() == \
        want.packed_keys.tobytes()
    assert got.packed_keys.tobytes() == \
        keys.from_reference(want.packed_keys).tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_oracle_forests_equal(ref, kind):
    want = ref.generators.generate(kind, 7, seed=2)
    got = generators.generate(kind, 7, seed=2)
    for name in ("kruskal", "boruvka_numpy"):
        w = getattr(ref.kruskal_ref, name)(want)
        g = getattr(kruskal_ref, name)(got)
        assert np.array_equal(g.edge_mask, w.edge_mask), name
        assert (g.total_weight, g.num_components, g.num_tree_edges) == \
            (w.total_weight, w.num_components, w.num_tree_edges), name


def test_graph_from_reference_arrays(ref):
    want = ref.generators.rmat(6, seed=1)
    got = graph_lib.Graph.from_arrays(want.src, want.dst, want.weight,
                                      want.num_vertices)
    got.validate()
    assert np.array_equal(keys.to_reference(got.packed_keys),
                          want.packed_keys)
    src, dst, key, valid = graph_lib.pad_edges(got, 64)
    rsrc, rdst, rkey, rvalid = ref.graph.pad_edges(want, 64)
    assert np.array_equal(src, rsrc) and np.array_equal(dst, rdst)
    assert np.array_equal(keys.to_reference(key), rkey)
    assert np.array_equal(valid, rvalid)


def test_key_conversions_and_lanes(ref):
    rng = np.random.default_rng(3)
    w = rng.random(200, dtype=np.float32)
    w[:3] = [0.0, 1e-9, np.float32(0.999)]
    eid = rng.integers(0, 2 ** 32, 200).astype(np.uint32)
    want = ref.keys.pack_keys_np(w, eid)
    got = keys.pack_keys_np(w, eid)
    assert np.array_equal(keys.to_reference(got), want)
    both = np.concatenate([want, [ref.keys.INF_KEY]])
    port = keys.from_reference(both)
    assert port[-1] == keys.INF_KEY
    assert np.array_equal(keys.to_reference(port), both)
    # Signed order of the port's words == unsigned order of the reference's.
    assert np.array_equal(np.argsort(port, kind="stable"),
                          np.argsort(both, kind="stable"))
    t = torch.from_numpy(port)
    with ref.enable_x64():
        import jax.numpy as jnp
        rhi, rlo = ref.keys.split_key_lanes(jnp.asarray(both))
        rw = ref.keys.unpack_weight(jnp.asarray(both[:-1]))
    hi, lo = keys.split_key_lanes(t)
    assert np.array_equal(hi.numpy(), np.asarray(rhi).astype(np.int64))
    assert np.array_equal(lo.numpy(), np.asarray(rlo).astype(np.int64))
    assert torch.equal(keys.combine_key_lanes(hi, lo), t)
    assert np.array_equal(keys.unpack_weight(t[:-1]).numpy(), np.asarray(rw))
    assert np.array_equal(keys.unpack_edge_id(t).numpy(),
                          (both & np.uint64(0xFFFFFFFF)).astype(np.int64))
    assert torch.equal(keys.pack_keys(torch.from_numpy(w), torch.from_numpy(
        eid.astype(np.int64))), t[:-1])
    assert np.array_equal(keys.unpack_weight_np(got), w)
    assert np.array_equal(keys.unpack_edge_id_np(got), eid)


@pytest.mark.parametrize("part", ["block", "hashed", "balanced"])
def test_edge_layouts_equal(ref, part):
    want_g = ref.generators.generate("rmat", 7, seed=4)
    got_g = generators.generate("rmat", 7, seed=4)
    for chunk in (8, 1024):
        w = ref.partition.build_edge_layout(
            want_g, ref.partition.get_partitioner(part), 1, chunk)
        g = partition.build_edge_layout(
            got_g, partition.get_partitioner(part), 1, chunk)
        assert (g.num_shards, g.block) == (w.num_shards, w.block)
        assert np.array_equal(g.eid, w.eid)
    assert partition.pow2ceil(1000) == ref.partition.pow2ceil(1000) == 1024


def test_hook_min_and_pointer_double(ref):
    rng = np.random.default_rng(9)
    n = 97
    a = rng.integers(0, n, 300)
    b = rng.integers(0, n, 300)
    hi, lo = np.maximum(a, b), np.minimum(a, b)
    valid = (rng.random(300) < 0.6) & (hi > lo)
    import jax.numpy as jnp
    want = ref.union_find.hook_min(n, jnp.asarray(hi), jnp.asarray(lo),
                                   jnp.asarray(valid))
    got = union_find.hook_min(n, torch.from_numpy(hi), torch.from_numpy(lo),
                              torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    want_pd = ref.union_find.pointer_double(want)
    got_pd = union_find.pointer_double(got)
    assert np.array_equal(got_pd.numpy(), np.asarray(want_pd).astype(np.int32))


def test_interval_loop_contract():
    """Sequential and double-buffered drivers consume the same readbacks;
    the pipelined one reports the overlap and its speculative interval."""
    for overlap in (False, True):
        stats = runtime.EngineStats()
        seen = []

        def dispatch(s):
            s = s + 1
            return s, runtime.Readback(torch.tensor([s]))

        def finish(s, vals):
            seen.append(vals[0])
            return s, vals[0] == 3

        out = runtime.interval_loop(0, dispatch, finish, stats=stats,
                                    max_intervals=10, fail_msg="x",
                                    overlap=overlap)
        assert seen == [1, 2, 3]
        assert stats.intervals == stats.host_syncs == 3
        assert out == (4 if overlap else 3)
        assert stats.overlapped_syncs == (3 if overlap else 0)
        assert stats.speculative_intervals == (1 if overlap else 0)
    with pytest.raises(RuntimeError, match="never"):
        runtime.interval_loop(
            0, lambda s: (s, runtime.Readback(torch.tensor([0]))),
            lambda s, v: (s, False), stats=runtime.EngineStats(),
            max_intervals=2, fail_msg="never")


def test_knob_validation_and_unported_paths():
    g = generators.rmat(5, seed=0)
    for bad in (dict(round_loop="x"), dict(round_kernel="x"),
                dict(interval_pipeline=2), dict(collective="x"),
                dict(partitioner="x")):
        with pytest.raises(ValueError):
            mst_api.minimum_spanning_forest(g, params=GHSParams(**bad),
                                            device="cpu")
    for unported in (dict(collective="compressed"),
                     dict(collective="compressed", round_loop="host")):
        with pytest.raises(NotImplementedError):
            mst_api.minimum_spanning_forest(g, params=GHSParams(**unported),
                                            device="cpu")
    for unported in (dict(mesh=object()),
                     dict(params=GHSParams(partitioner="hashed"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mst_api.minimum_spanning_forest(g, method="ghs", device="cpu",
                                            **unported)
    for unported in (dict(mesh=object()),
                     dict(params=GHSParams(collective="compressed"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mst_api.minimum_spanning_forest(g, method="filter_boruvka",
                                            device="cpu", **unported)
    with pytest.raises(ValueError):
        mst_api.minimum_spanning_forest(g, method="nope", device="cpu")
    for loop in ("device", "host"):
        with pytest.raises(NotImplementedError):
            mst_api.minimum_spanning_forest(
                g, params=GHSParams(round_loop=loop), device="cpu",
                mesh=object())
    with pytest.raises(NotImplementedError, match="Graph.*or.*DeviceEdges"):
        mst_api.minimum_spanning_forest((g.src, g.dst), device="cpu")


def test_no_cpu_fallback(monkeypatch):
    """With no card, the default device raises instead of running on CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mst_api.minimum_spanning_forest(generators.rmat(5, seed=0))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "from repro_torch.core import mst_api, generators, kruskal_ref\n"
        "from repro_torch.kernels.segment_min import ops as a\n"
        "from repro_torch.kernels.spmv_minplus import ops as b\n"
        "from repro_torch.kernels import build\n"
        "from repro_torch.kernels.edge_hash import ops as c\n"
        "from repro_torch.core import ghs_state\n"
        "from repro_torch.core.params import GHSParams\n"
        "import numpy as np\n"
        "g = generators.rmat(6, seed=0)\n"
        "for kw in (dict(round_kernel='xla'), dict(round_kernel='pallas'),\n"
        "           dict(round_loop='host')):\n"
        "    res, _ = mst_api.minimum_spanning_forest(\n"
        "        g, params=GHSParams(use_pallas=True, **kw), device='cpu')\n"
        "    assert (res.edge_mask == kruskal_ref.kruskal(g).edge_mask).all()\n"
        "from repro_torch.core import pipeline\n"
        "spec = pipeline.GraphSpec('geo_knn', 6, seed=1)\n"
        "dev = pipeline.build(spec, device='cpu')\n"
        "res, st = mst_api.minimum_spanning_forest(dev, device='cpu')\n"
        "assert st.edge_staging == 'device'\n"
        "assert (res.edge_mask == kruskal_ref.kruskal(\n"
        "    pipeline.build_host(spec)).edge_mask).all()\n"
        "many, bst = mst_api.minimum_spanning_forests([g, dev], device='cpu')\n"
        "assert (many[0].edge_mask == kruskal_ref.kruskal(g).edge_mask).all()\n"
        "assert bst.host_syncs == bst.intervals + bst.buckets\n"
        "pos = np.arange(g.num_edges, dtype=np.int32)\n"
        "t = c.build_table(g.src, g.dst, pos, 4 * g.num_edges + 1)\n"
        "got = c.lookup(t, g.src, g.dst, device='cpu')\n"
        "assert (got.numpy() == pos).all()\n"
        "import dataclasses\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import serve_lm\n"
        "from repro_torch.models import api, convert, layers, transformer\n"
        "from repro_torch.kernels.flash_attention import ops as d\n"
        "from repro_torch.kernels.decode_attention import ops as e\n"
        "cfg = dataclasses.replace(get_config('qwen1.5-0.5b', smoke=True),\n"
        "                          n_layers=1)\n"
        "res = serve_lm.serve(cfg, batch=2, prompt_len=9, gen=3, device='cpu')\n"
        "assert res.seqs.shape == (2, 3) and res.logits_finite\n"
        "from repro_torch.models import rwkv6\n"
        "from repro_torch.kernels.rwkv6 import ops as f\n"
        "res = serve_lm.serve(get_config('rwkv6-3b', smoke=True), batch=2,\n"
        "                     prompt_len=9, gen=3, device='cpu')\n"
        "assert res.seqs.shape == (2, 3) and res.logits_finite\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_port_sources_import_neither_jax_nor_repro():
    """No module of the port and not ``chip_smoke.py`` names ``jax`` or
    ``repro`` in an import statement, at any depth of the file."""
    import ast
    pkg = Path(repro_torch.__file__).resolve().parent
    files = sorted(pkg.rglob("*.py")) + [pkg.parents[1] / "chip_smoke.py"]
    for module in ("core/pipeline.py", "core/boruvka_dist.py",
                   "core/mst_api.py"):
        assert pkg / module in files, module
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path.name} imports {name}"

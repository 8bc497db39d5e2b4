"""The port's input shapes (``configs/shapes.py``), sharding rules
(``sharding/specs.py``) and production meshes (``launch/mesh.py``) held
against the JAX package's, on the CPU.

* ``SHAPES`` and ``applicable`` equal the JAX package's for every arch and
  shape; ``ShardingRules.logical`` for every logical name, and
  ``make_rules`` for the three sets of axis names.  The port reads a
  DeviceMesh over a ``fake_world`` group; the JAX functions read only
  ``axis_names`` and ``.shape``, so a stand-in with those serves them.
* ``param_spec`` on all ten full configs, on pod16x16, multipod2x16x16 and
  a (2, 4) mesh: every JAX leaf's spec (from ``jax.eval_shape`` of the
  JAX init, over the stand-in) equals the spec of each port parameter
  stacked into that leaf (the port's model on ``meta``, the mesh a
  DeviceMesh), mapped back through ``models/convert``'s layout: the stack
  axes ``None``, the two trailing entries swapped for a name in
  ``convert.TRANSPOSED``.
* ``placements`` over a ``fake_world`` mesh: each local shard is each
  dimension divided by the product of its mesh axes; the fake group is
  gone when ``fake_world`` exits, also when its body raises.
"""
import contextlib
import dataclasses
import math
import sys
import types

import pytest
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs
from repro_torch.configs import shapes
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import convert
from repro_torch.sharding import specs

MESHES = {
    "pod16x16": {"data": 16, "model": 16},
    "multipod2x16x16": {"pod": 2, "data": 16, "model": 16},
    "host2x4": {"data": 2, "model": 4},
}
LOGICAL = (None, "batch", "heads", "ff", "vocab", "experts", "model", "seq",
           "batch_heads", "fsdp")


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's shapes, rules, meshes and models, imported for
    this module only (the ``jax.experimental.enable_x64`` name is installed
    for the import and removed again with the ``repro`` modules on
    teardown; hazard H1).  ``cache`` holds each arch's JAX leaves and the
    port's parameters once for the module."""
    import jax
    import jax.experimental
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro import configs
        from repro.configs import shapes as rshapes
        from repro.launch import mesh as rmesh
        from repro.models import api as rapi
        from repro.sharding import specs as rspecs
        yield types.SimpleNamespace(
            jax=jax, configs=configs, shapes=rshapes, mesh=rmesh, api=rapi,
            specs=rspecs, cache={})
    finally:
        if shimmed:
            del jax.experimental.enable_x64
        for name in _repro_modules():
            del sys.modules[name]
        sys.modules.update(saved)


def _stand_in(axes: dict):
    """A mesh with only what the JAX rules read: ``axis_names`` and
    ``.shape``, name -> size."""
    return types.SimpleNamespace(shape=dict(axes), axis_names=tuple(axes))


@contextlib.contextmanager
def _port_mesh(axes: dict):
    """A DeviceMesh of ``axes`` (name -> size) over a fake group of as
    many ranks, for the body of the ``with``."""
    from torch.distributed.device_mesh import init_device_mesh
    with port_mesh.fake_world(math.prod(axes.values())):
        yield init_device_mesh(port_mesh.DEVICE_TYPE, tuple(axes.values()),
                               mesh_dim_names=tuple(axes))


# --------------------------------------------------------------------------
# shapes
# --------------------------------------------------------------------------

def test_shapes_equal_reference(ref):
    assert list(shapes.SHAPES) == list(ref.shapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            ref.shapes.SHAPES[name])


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_applicable_equals_reference(ref, arch, shape):
    got = shapes.applicable(get_config(arch), shapes.SHAPES[shape])
    want = ref.shapes.applicable(ref.configs.get_config(arch),
                                 ref.shapes.SHAPES[shape])
    assert got == want
    assert got[0] == (shape != "long_500k"
                      or get_config(arch).family in ("ssm", "hybrid"))


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES) + ["one_axis"])
def test_make_rules_equals_reference(ref, mesh_name):
    axes = MESHES.get(mesh_name, {"shards": 8})
    with _port_mesh(axes) as mesh:
        got = port_mesh.make_rules(mesh)
    want = ref.mesh.make_rules(_stand_in(axes))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", LOGICAL)
def test_logical_equals_reference(ref, name):
    for axes in list(MESHES.values()) + [{"shards": 8}]:
        with _port_mesh(axes) as mesh:
            got = port_mesh.make_rules(mesh)
        want = ref.mesh.make_rules(_stand_in(axes))
        assert got.logical(name) == want.logical(name)
    assert specs.ShardingRules().logical(name) == \
        ref.specs.ShardingRules().logical(name)
    with pytest.raises(KeyError):
        specs.ShardingRules().logical("no-such-axis")


def _reference_key(name: str, family: str) -> tuple:
    """The JAX leaf path of a port parameter and its number of stack
    axes, by ``models/convert``'s layout."""
    _, stacks = convert.MODELS[family]
    top, _, rest = name.partition(".")
    if top not in stacks:
        return name.replace(".", "/"), 0
    _, _, rest = rest.partition(".")
    sub, _, tail = rest.partition(".")
    if family == "hybrid" and sub in convert.SUBSTACKED:
        _, _, tail = tail.partition(".")
        return f"{top}/{sub}/{tail}".replace(".", "/"), 2
    return f"{top}/{rest}".replace(".", "/"), 1


def _arch_leaves(ref, arch):
    """(JAX {path: shape}, port [(name, shape)]) of ``arch``'s full
    config: the JAX init traced abstractly, the port's model on meta."""
    if arch not in ref.cache:
        rcfg = ref.configs.get_config(arch)
        tree = ref.jax.eval_shape(
            lambda r: ref.api.get_model(rcfg).init(r, rcfg),
            ref.jax.random.PRNGKey(0))
        jleaves = {p: tuple(v.shape)
                   for p, v in ref.specs.tree_paths(tree).items()}
        cfg = get_config(arch)
        cls, _ = convert.MODELS[cfg.family]
        model = cls(cfg, device="meta")
        ref.cache[arch] = (jleaves, [(n, tuple(p.shape)) for n, p in
                                     model.named_parameters()])
    return ref.cache[arch]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(ref, arch, mesh_name):
    axes = MESHES[mesh_name]
    jmesh = _stand_in(axes)
    rrules = ref.mesh.make_rules(jmesh)
    family = get_config(arch).family
    jleaves, port = _arch_leaves(ref, arch)
    jspecs = {}
    for path, shape in jleaves.items():
        p = tuple(ref.specs.param_spec(path, shape, rrules, jmesh))
        jspecs[path] = p + (None,) * (len(shape) - len(p))
    seen = set()
    with _port_mesh(axes) as mesh:
        rules = port_mesh.make_rules(mesh)
        for name, shape in port:
            key, n_stack = _reference_key(name, family)
            jshape, jspec = jleaves[key], jspecs[key]
            assert jspec[:n_stack] == (None,) * n_stack, (key, jspec)
            want, wshape = jspec[n_stack:], jshape[n_stack:]
            if key.rsplit("/", 1)[-1] in convert.TRANSPOSED and \
                    len(want) >= 2:
                want = want[:-2] + (want[-1], want[-2])
                wshape = wshape[:-2] + (wshape[-1], wshape[-2])
            assert shape == wshape, (name, shape, jshape)
            assert specs.param_spec(name, shape, rules, mesh) == want, name
            seen.add(key)
        sharded = [n for n, s in port
                   if any(specs.param_spec(n, s, rules, mesh))]
    assert seen == set(jleaves)
    assert sharded, "no parameter is sharded"


def test_param_spec_drops_indivisible_and_replicates_unmatched():
    with _port_mesh(MESHES["pod16x16"]) as mesh:
        rules = port_mesh.make_rules(mesh)
        # (out, in) = (40 heads · 128, 5120): heads over model, fsdp over
        # data
        assert specs.param_spec("layers.0.attn.wq", (5120, 5120), rules,
                                mesh) == ("model", "data")
        assert specs.param_spec("layers.0.attn.wq", (5120, 5121), rules,
                                mesh) == ("model", None)
        assert specs.param_spec("layers.0.attn.wq", (5120, 5121),
                                rules) == ("model", "data")
        assert specs.param_spec("layers.0.ln1", (5120,), rules,
                                mesh) == (None,)
        assert specs.param_spec("embed", (151936, 1024), rules, mesh) == \
            ("model", "data")
        assert specs.param_spec("layers.0.moe.e_wi", (60, 2048, 1408),
                                rules, mesh) == (None, "data", None)


# --------------------------------------------------------------------------
# meshes over a fake process group
# --------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_placements_give_local_shards(multi_pod):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    ranks = 512 if multi_pod else 256
    cfg = get_config("qwen2.5-32b")
    model = convert.MODELS[cfg.family][0](
        dataclasses.replace(cfg, n_layers=1), device="meta")
    with port_mesh.fake_world(ranks):
        mesh = port_mesh.make_production_mesh(multi_pod=multi_pod)
        assert mesh.size() == ranks
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert mesh.mesh_dim_names == names
        sizes = specs.mesh_axes(mesh)
        rules = port_mesh.make_rules(mesh)
        n_sharded = 0
        for name, spec in specs.param_specs(model, rules, mesh).items():
            p = model.get_parameter(name)
            pl = specs.placements(spec, mesh)
            assert len(pl) == len(names)
            local = distribute_tensor(p.detach(), mesh, pl).to_local()
            want = []
            for dim, entry in zip(p.shape, spec):
                axes = (() if entry is None else (entry,)
                        if isinstance(entry, str) else entry)
                div = 1
                for a in axes:
                    div *= sizes[a]
                    assert pl[names.index(a)] == Shard(len(want))
                want.append(dim // div)
            assert tuple(local.shape) == tuple(want), name
            n_sharded += local.numel() < p.numel()
            for a, placement in zip(names, pl):
                if not any(a == e or (isinstance(e, tuple) and a in e)
                           for e in spec):
                    assert placement == Replicate()
        assert n_sharded >= 9
    assert not dist.is_initialized()


def test_placements_reject_a_bad_spec():
    from torch.distributed.device_mesh import init_device_mesh
    with port_mesh.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with pytest.raises(ValueError, match="two dims"):
            specs.placements(("data", "data"), mesh)
        with pytest.raises(ValueError, match="lacks"):
            specs.placements(("pod", None), mesh)


def test_fake_world_is_destroyed_on_exit_and_on_raise():
    assert not dist.is_initialized()
    with port_mesh.fake_world(256):
        assert dist.get_world_size() == 256 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="open already"):
            with port_mesh.fake_world(8):
                pass
        with pytest.raises(RuntimeError, match="512 ranks"):
            port_mesh.make_production_mesh(multi_pod=True)
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with port_mesh.fake_world(512):
            assert dist.get_world_size() == 512
            1 / 0
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake_world"):
        port_mesh.make_production_mesh()


def test_host_mesh():
    with pytest.raises(NotImplementedError, match="item 13b"):
        port_mesh.make_host_mesh(2, 4)
    with port_mesh.fake_world(1):
        mesh = port_mesh.make_host_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        rules = port_mesh.make_rules(mesh)
        assert rules.batch == ("data",) and rules.model == "model"
    assert not dist.is_initialized()


def test_specs_of_a_model_cover_its_parameters():
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    model = convert.MODELS[cfg.family][0](cfg, device="meta")
    rules = specs.ShardingRules()
    got = specs.param_specs(model, rules)
    assert list(got) == [n for n, _ in model.named_parameters()]
    for name, spec in got.items():
        assert len(spec) == model.get_parameter(name).ndim

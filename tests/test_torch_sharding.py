"""The port's sharding rules and meta-device stand-ins against JAX's.

Pure and fast: no ranks, no devices.  For all 10 archs at full width, on
abstract meshes (16, 16), (2, 16, 16) and (4, 2), in both variants, the
port's param specs equal JAX's leaf by leaf (a layer-list leaf's spec is
JAX's stacked spec without its leading ``None``), as do ``batch_spec``
and ``cache_entry_spec`` at every supported cell.  ``launch/specs.py``'s
meta tensors carry JAX's ``eval_shape`` shapes and dtypes for every arch
x supported shape.  Then the placements ``to_shardings`` gives, and its
refusal of a tuple entry out of mesh order.
"""

import functools

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import (ARCH_IDS, SHAPES, get_config as jget_config,
                           supported_shapes)
from repro.distributed import sharding as jshd
from repro.launch import specs as JS
from repro.launch.mesh import dp_axes as jdp_axes
from repro.launch.mesh import make_abstract_mesh as jmake_abstract_mesh
from repro_torch.configs import get_config
from repro_torch.convert import LAYER_STACKS
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import dp_axes, make_abstract_mesh
from repro_torch.tree import leaves_with_path

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JS.param_specs_struct(jget_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return S.param_specs_struct(get_config(arch))


def _meshes(name):
    shape, axes = MESHES[name]
    return make_abstract_mesh(shape, axes), jmake_abstract_mesh(shape, axes)


def _jax_leaf(tree, path):
    """JAX's leaf for a port path; a layer-list index drops out (JAX
    stacks the layers).  Returns (leaf, stacked)."""
    stacked = path[0] in LAYER_STACKS
    if stacked:
        path = (path[0],) + path[2:]
    for k in path:
        tree = tree[k]
    return tree, stacked


def _spec_leaves(tree, path=()):
    """``[(path, spec)]`` of a spec tree (a spec is a tuple: a leaf)."""
    if isinstance(tree, shd.P):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _spec_leaves(tree[k], path + (k,))]
    return [kv for i, v in enumerate(tree)
            for kv in _spec_leaves(v, path + (i,))]


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("variant", ["train", "serve"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh_name, variant):
    mesh, jmesh = _meshes(mesh_name)
    jparams = _jax_params(arch)
    shd.set_variant(variant)
    jshd.set_variant(variant)
    try:
        specs = shd.param_specs(_port_params(arch), mesh)
        jspecs = jshd.param_specs(jparams, jmesh)
    finally:
        shd.set_variant("train")
        jshd.set_variant("train")
    n_jax = len(jax.tree.leaves(jparams))
    got = _spec_leaves(specs)
    assert len(got) == len(leaves_with_path(_port_params(arch)))
    seen = set()
    for path, spec in got:
        jspec, stacked = _jax_leaf(jspecs, path)
        want = tuple(jspec)[1:] if stacked else tuple(jspec)
        assert tuple(spec) == want, (path, spec, jspec)
        seen.add(tuple(k for k in path if not isinstance(k, int)))
    assert len(seen) == n_jax


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_structs_equal_jax_shapes(arch):
    params = _port_params(arch)
    jparams = _jax_params(arch)
    for path, t in leaves_with_path(params):
        assert t.device.type == "meta"
        j, stacked = _jax_leaf(jparams, path)
        assert tuple(t.shape) == (j.shape[1:] if stacked else j.shape), path
        assert _dtype(t) == str(j.dtype), path
    ostate = S.opt_specs_struct(params)
    jstate = JS.opt_specs_struct(jparams)
    for k in ("m", "v"):
        for path, t in leaves_with_path(ostate[k]):
            j, stacked = _jax_leaf(jstate[k], path)
            assert t.device.type == "meta"
            assert tuple(t.shape) == (j.shape[1:] if stacked else j.shape)
            assert _dtype(t) == str(j.dtype) == "float32"
    assert tuple(ostate["step"].shape) == jstate["step"].shape
    assert _dtype(ostate["step"]) == str(jstate["step"].dtype)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_batch_and_cache_specs_equal_jax(arch, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    assert dp_axes(mesh) == jdp_axes(jmesh)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shp in supported_shapes(arch):
        shape = SHAPES[shp]
        got, want = S.input_specs(cfg, shape), JS.input_specs(jcfg, shape)
        gl = leaves_with_path(got)
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in gl] == [tuple(k.key for k in p)
                                      for p, _ in wl], shp
        for (path, t), (_, j) in zip(gl, wl):
            assert t.device.type == "meta"
            assert tuple(t.shape) == j.shape and _dtype(t) == str(j.dtype), \
                (shp, path)
        if shape.kind == "decode":
            specs = shd.cache_specs(got["cache"], mesh, dp_axes(mesh))
            jspecs = jshd.cache_specs(want["cache"], jmesh, jdp_axes(jmesh))
            assert {k: tuple(v) for k, v in specs.items()} == \
                {k: tuple(v) for k, v in jspecs.items()}, shp
        else:
            for name, t in got["batch"].items():
                assert tuple(shd.batch_spec(name, t.shape, mesh,
                                            dp_axes(mesh))) == \
                    tuple(jshd.batch_spec(name, t.shape, jmesh,
                                          jdp_axes(jmesh))), (shp, name)


def test_serve_variant_strips_fsdp_like_jax():
    mesh, _ = _meshes("16x16")
    params = _port_params("olmo-1b")
    axes = lambda specs: {a for _, s in _spec_leaves(specs)
                          for e in s if e for a in
                          (e if isinstance(e, tuple) else (e,))}
    base = shd.param_specs(params, mesh)
    shd.set_variant("serve")
    try:
        serve = shd.param_specs(params, mesh)
    finally:
        shd.set_variant("train")
    assert shd.get_variant() == "train"
    assert "data" in axes(base) and "data" not in axes(serve)
    assert "model" in axes(serve)
    with pytest.raises(ValueError):
        shd.set_variant("bogus")


def test_to_shardings_placements():
    m42 = make_abstract_mesh((4, 2), ("data", "model"))
    pod = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    sh = shd.to_shardings({"w": shd.P("data", "model"),
                           "e": shd.P("model", None), "n": shd.P(),
                           "l": [shd.P(None, "data")]}, m42)
    assert sh["w"].placements == (Shard(0), Shard(1))
    assert sh["e"].placements == (Replicate(), Shard(0))
    assert sh["n"].placements == (Replicate(), Replicate())
    assert sh["l"][0].placements == (Shard(1), Replicate())
    # a tuple entry in mesh order: both mesh dims split that tensor dim
    s = shd.NamedSharding(pod, shd.P(("pod", "data"), None, "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    # opt state specs: the param specs twice and a replicated step
    ospecs = shd.opt_state_specs({"w": shd.P("data")}, m42)
    assert ospecs == {"m": {"w": ("data",)}, "v": {"w": ("data",)},
                      "step": ()}


def test_a_tuple_entry_out_of_mesh_order_raises():
    """``cache_entry_spec`` puts ``("model", "data")`` on the sequence dim
    of a KV cache whose heads do not divide ``model`` and whose batch does
    not divide ``data``: JAX shards it model-major, DTensor would shard it
    data-major (other rows on each rank), so ``to_shardings`` refuses."""
    mesh, jmesh = _meshes("4x2")
    shape = (2, 1, 64, 1, 16)          # (L, B, S, K, hd): K=1, B=1
    spec = shd.cache_entry_spec("k", shape, mesh)
    assert tuple(spec) == tuple(jshd.cache_entry_spec("k", shape, jmesh)) \
        == (None, None, ("model", "data"), None, None)
    with pytest.raises(ValueError, match="out of mesh order"):
        shd.to_shardings({"k": spec}, mesh)["k"].placements
    # the spec type survives a round trip and compares as a tuple
    import pickle

    assert pickle.loads(pickle.dumps(spec)) == spec
    assert repr(shd.P("data", None)) == "P('data', None)"


def test_mesh_module_needs_no_process_group():
    """Importing and abstract meshes touch no device or group; a real mesh
    without a process group raises."""
    from repro_torch.launch import mesh as M

    am = M.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert am.shape == {"pod": 2, "data": 16, "model": 16}
    assert am.size == 512 and M.dp_axes(am) == ("pod", "data")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        M.make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        M.make_host_mesh(2)

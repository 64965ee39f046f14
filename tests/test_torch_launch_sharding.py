"""Port parity: meshes, sharding rules and per-device argument bytes.

* ``param_spec`` equals the reference's for every leaf path of every
  arch (float and ``quantized_serve`` trees).
* ``sanitize_spec`` equals the reference's, both called with a stand-in
  mesh (all either reads is ``shape`` and ``axis_names``), on the
  single- and multi-pod meshes for every leaf.
* The per-device argument bytes of every pair's ``input_specs`` equal
  those summed from the reference's ``ShapeDtypeStruct`` trees on a
  ``jax.sharding.AbstractMesh`` of the same axes (their
  ``NamedSharding.shard_shape``), leaf for leaf; the only gap is the
  optimizer step counter, a device int32 in the reference and a host
  int in the port (4 bytes a train pair).
* The reference's ``tests/test_sharding_specs.py`` ``TestSanitize`` and
  ``TestRules`` cases on the port; meshes (abstract, over devices, the
  host mesh), ``mesh_context``, ``shard_hint``, ``replicated``.
"""

import dataclasses
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ARCH_IDS, SHAPES as J_SHAPES
from repro.configs.base import get_config as j_config
from repro.launch import mesh as JMESH
from repro.launch import sharding as JSH
from repro.launch import specs as JSPEC
from repro.models import model as JM
from repro_torch.configs import base as TC
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TSH
from repro_torch.launch import specs as TSPEC
from repro_torch.launch.steps import shape_supported
from repro_torch.models import model as TM


class FakeMesh:
    """Minimal stand-in so rule tests don't need 256 devices."""

    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
T_MESH = TMESH.make_production_mesh(abstract=True)
T_MESH3 = TMESH.make_production_mesh(multi_pod=True, abstract=True)


# ------------------------------------------------ the reference's own cases
class TestSanitize:
    def test_drops_nondivisible(self):
        spec = TSH.sanitize_spec(MESH, (40, 128), ("model", "data"))
        assert spec[0] is None and spec[1] == "data"

    def test_keeps_divisible(self):
        spec = TSH.sanitize_spec(MESH, (64, 128), ("model", "data"))
        assert spec[0] == "model" and spec[1] == "data"

    def test_compound_axis_prefix_fallback(self):
        spec = TSH.sanitize_spec(MESH3, (32,), (("pod", "data"),))
        assert spec[0] == ("pod", "data")
        spec = TSH.sanitize_spec(MESH3, (2,), (("pod", "data"),))
        assert spec[0] == "pod"
        spec = TSH.sanitize_spec(MESH3, (3,), (("pod", "data"),))
        assert spec[0] is None

    def test_missing_axis_dropped(self):
        spec = TSH.sanitize_spec(MESH, (64,), ("pod",))
        assert spec[0] is None

    def test_port_mesh_record_sanitizes_as_the_stand_in(self):
        for shape, spec in (((40, 128), ("model", "data")),
                            ((32,), (("pod", "data"),)), ((2,), ("pod",))):
            assert TSH.sanitize_spec(T_MESH3, shape, spec) == \
                TSH.sanitize_spec(MESH3, shape, spec)


class TestRules:
    def test_expert_weights_expert_parallel(self):
        spec = TSH.param_spec("blocks/pos0/moe/experts/wi", (4, 128, 512, 1024))
        assert spec == (None, "model", "data", None)

    def test_attention_projections(self):
        assert TSH.param_spec("blocks/pos0/wq", (4, 512, 512)) == \
            (None, "data", "model")
        assert TSH.param_spec("blocks/pos0/wo", (4, 512, 512)) == \
            (None, "model", "data")

    def test_embed_vocab_sharded(self):
        assert TSH.param_spec("embed", (50000, 512)) == ("model", "data")

    def test_norms_replicated(self):
        assert TSH.param_spec("blocks/pos0/mlp_norm", (4, 512)) == \
            (None, None)
        assert TSH.param_spec("final_norm", (512,)) == (None,)


# --------------------------------------------------------- every leaf, both
@pytest.mark.parametrize("qserve", [False, True], ids=["float", "qserve"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_and_sanitize_equal_reference(arch, qserve):
    t = dataclasses.replace(TC.get_config(arch), quantized_serve=qserve)
    j = dataclasses.replace(j_config(arch), quantized_serve=qserve)
    t_leaves = TSH.tree_paths(TM.param_shapes(t))
    j_leaves = JSH.tree_paths(JM.param_shapes(j))
    assert t_leaves == j_leaves
    for path, shape in t_leaves:
        spec = TSH.param_spec(path, shape)
        assert spec == JSH.param_spec(path, shape), path
        for mesh in (MESH, MESH3):
            assert tuple(TSH.sanitize_spec(mesh, shape, spec)) == \
                tuple(JSH.sanitize_spec(mesh, shape, spec)), (path, mesh.shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_shard_every_leaf(arch):
    cfg = TC.get_config(arch)
    shardings = TSH.param_shardings(T_MESH, TM.param_shapes(cfg))
    flat = dict(TSH.tree_paths(TM.param_shapes(cfg)))
    got = dict(TSH.tree_paths(shardings))
    assert set(got) == set(flat)
    for path, ns in got.items():
        local = ns.shard_shape(flat[path])
        assert ns.mesh is T_MESH and len(local) == len(flat[path])
        for dim, n, ax in zip(flat[path], local, tuple(ns.spec) +
                              (None,) * len(local)):
            assert n * TSH._axis_size(T_MESH, ax) == dim, path


def _ref_local_bytes(tree) -> int:
    return sum(math.prod(s.sharding.shard_shape(s.shape)) * s.dtype.itemsize
               for s in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_per_device_equal_reference(arch, mesh_kind):
    multi = mesh_kind == "multi"
    j_mesh = AbstractMesh((2, 16, 16) if multi else (16, 16),
                          ("pod", "data", "model") if multi
                          else ("data", "model"))
    t_mesh = T_MESH3 if multi else T_MESH
    t, j = TC.get_config(arch), j_config(arch)
    for name, shape in TC.SHAPES.items():
        if not shape_supported(t, shape)[0]:
            continue
        t_specs = TSPEC.input_specs(t, shape, t_mesh)
        j_specs = JSPEC.input_specs(j, J_SHAPES[name], j_mesh)
        step = 4 if shape.kind == "train" else 0
        assert TSPEC.argument_size_in_bytes(t_specs) + step == \
            _ref_local_bytes(j_specs), (name, mesh_kind)
        # leaf for leaf (as multisets of shard shapes)
        j_leaves = _without_step(j_specs) if shape.kind == "train" \
            else jax.tree_util.tree_leaves(j_specs)
        assert sorted(s.local_shape for s in TSPEC.spec_leaves(t_specs)) \
            == sorted(tuple(s.sharding.shard_shape(s.shape))
                      for s in j_leaves), (name, mesh_kind)


def _without_step(j_specs):
    params, opt, batch = j_specs
    return jax.tree_util.tree_leaves((params, opt.mu, opt.nu, opt.master,
                                      batch))


# ------------------------------------------------------------------- meshes
def test_production_meshes_have_the_reference_axes():
    assert T_MESH.shape == {"data": 16, "model": 16} and T_MESH.size == 256
    assert T_MESH3.shape == {"pod": 2, "data": 16, "model": 16}
    assert T_MESH3.size == 512 and T_MESH.devices == ()
    for tm, fm in ((T_MESH, MESH), (T_MESH3, MESH3)):
        assert TMESH.data_axes(tm) == JMESH.data_axes(fm)
        assert TMESH.batch_shards(tm) == JMESH.batch_shards(fm)


def test_production_mesh_over_devices_raises_without_them():
    with pytest.raises(ValueError, match="spans 256 devices"):
        TMESH.make_production_mesh()
    with pytest.raises(ValueError, match="spans 512 devices"):
        TMESH.make_production_mesh(multi_pod=True)


def test_host_mesh_is_one_device():
    m = TMESH.make_host_mesh("cpu")
    assert m.shape == {"data": 1, "model": 1}
    assert m.devices == (torch.device("cpu"),)
    assert TMESH.data_axes(m) == ("data",) and TMESH.batch_shards(m) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TMESH.make_host_mesh()
    with pytest.raises(ValueError):
        TMESH.Mesh(("data",), (2,), (torch.device("cpu"),))


def test_mesh_context_and_hint():
    assert TSH.get_mesh() is None
    with TSH.mesh_context(T_MESH) as m:
        assert m is T_MESH and TSH.get_mesh() is T_MESH
        with TSH.mesh_context(T_MESH3):
            assert TSH.get_mesh() is T_MESH3
        assert TSH.get_mesh() is T_MESH
        x = torch.ones(4, 4)
        assert TSH.shard_hint(x, "data", "model") is x
    assert TSH.get_mesh() is None
    r = TSH.replicated(T_MESH)
    assert tuple(r.spec) == () and r.shard_shape((32, 7)) == (32, 7)
    assert tuple(TSH.P("data", None)) == ("data", None)
    ns = TSH.NamedSharding(T_MESH, TSH.P("model"))
    with pytest.raises(ValueError, match="does not split"):
        ns.shard_shape((40,))

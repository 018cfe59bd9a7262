"""The port's sharding rules held against the JAX package's: every spec
the port's ``ShardingRules`` gives (a tuple standing in for a
PartitionSpec) equals the reference's ``tuple(PartitionSpec)`` for the
params and the AdamW / Adafactor state of every architecture and the batch
and cache of every (arch x shape) cell, on the 16x16 and 2x16x16 meshes,
with FSDP on and off.  The reference's rules run against a stand-in mesh
(axis names and sizes only, as ``tests/test_dryrun.py`` does), so no
devices are made on either side."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import shape_applicable as jax_applicable
from repro.launch.mesh import ShardingRules as JaxRules
from repro.models import input_specs as jax_input_specs
from repro.models import param_shapes as jax_param_shapes
from repro.train import opt_state_shapes as jax_opt_state_shapes
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.mesh import (MESHES, Mesh, ShardingRules, axis_size,
                                     dp_axes, local_shape,
                                     make_host_mesh, make_production_mesh,
                                     per_device_bytes)
from repro_torch.models import input_specs, param_shapes
from repro_torch.models.decode import TensorSpec
from repro_torch.train import opt_state_shapes
from repro_torch.tree import tree_items, tree_leaves

MESH_NAMES = ["16x16", "2x16x16"]
CELLS = [(a, s) for a in JAX_ARCHS for s in JAX_SHAPES
         if jax_applicable(JAX_ARCHS[a], JAX_SHAPES[s])[0]]


class StandInMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, mesh: Mesh):
        self.shape = mesh.shape
        self.axis_names = mesh.axis_names


def _jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


def _rules(arch, mesh_name, fsdp):
    mesh = MESHES[mesh_name]
    return (ShardingRules(ARCHS[arch], mesh, fsdp=fsdp),
            JaxRules(JAX_ARCHS[arch], StandInMesh(mesh), fsdp=fsdp))


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_param_and_opt_specs_equal_jax(arch, mesh_name, fsdp):
    rules, jrules = _rules(arch, mesh_name, fsdp)
    tp = MESHES[mesh_name].shape["model"]
    shapes = param_shapes(ARCHS[arch], tp_pad=tp)
    jshapes = jax_param_shapes(JAX_ARCHS[arch], tp)
    specs, jspecs = rules.param_specs(shapes), jrules.param_specs(jshapes)
    assert dict(tree_items(specs)) == _jax_specs(jspecs)
    for opt in ("adamw", "adafactor"):
        got = rules.opt_specs(opt_state_shapes(opt, shapes), specs)
        want = jrules.opt_specs(jax_opt_state_shapes(opt, jshapes), jspecs)
        assert dict(tree_items(got)) == _jax_specs(want), opt


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_specs_equal_jax(arch, shape, mesh_name, fsdp):
    rules, jrules = _rules(arch, mesh_name, fsdp)
    got = input_specs(ARCHS[arch], SHAPES[shape])
    want = jax_input_specs(JAX_ARCHS[arch], JAX_SHAPES[shape])
    if SHAPES[shape].kind == "decode":
        assert dict(tree_items(rules.cache_specs(got["cache"]))) \
            == _jax_specs(jrules.cache_specs(want["cache"]))
        got, want = {"tokens": got["tokens"]}, {"tokens": want["tokens"]}
    assert dict(tree_items(rules.batch_specs(got))) \
        == _jax_specs(jrules.batch_specs(want))


def test_sharding_rules_divisibility():
    """Every param leaf's sharded dims must divide by the mesh axis size
    for every arch (the invariant the dry-run relies on)."""
    mesh = make_production_mesh()
    for name, cfg in ARCHS.items():
        shapes = param_shapes(cfg, tp_pad=16)
        specs = dict(tree_items(ShardingRules(cfg, mesh).param_specs(shapes)))
        for path, s in tree_items(shapes):
            for dim, ax in zip(s.shape, specs[path]):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                size = int(np.prod([mesh.shape[a] for a in axes]))
                assert dim % size == 0, (name, tuple(s.shape), specs[path])


def test_meshes():
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    multi = make_production_mesh(multi_pod=True)
    assert (multi.name, multi.size) == ("2x16x16", 512)
    assert dp_axes(multi) == ("pod", "data")
    assert axis_size(multi, "pod", "data") == 32
    assert axis_size(make_production_mesh(), "pod", "data") == 16


def test_local_shape_and_per_device_bytes_by_hand():
    mesh = make_production_mesh(multi_pod=True)
    assert local_shape((64, 4096, 8), (None, ("pod", "data"), "model"),
                       mesh) == (64, 128, 1)
    assert local_shape((30, 4096), (), mesh) == (30, 4096)
    tree = {"a": TensorSpec((32, 48), torch.bfloat16),
            "b": {"c": TensorSpec((7,), torch.float32)}}
    specs = {"a": (("pod", "data"), "model"), "b": {"c": ()}}
    assert per_device_bytes(tree, specs, mesh) == 1 * 3 * 2 + 7 * 4


def test_fsdp_shards_deepseek_params_over_all_256_cards():
    """deepseek-7b's params with FSDP on 16x16: every large leaf is split
    over both axes, so a card holds about 1/256 of the bf16 tree."""
    mesh = make_production_mesh()
    shapes = param_shapes(ARCHS["deepseek-7b"], tp_pad=16)
    total = sum(p.numel() * p.element_size() for p in tree_leaves(shapes))
    held = per_device_bytes(
        shapes, ShardingRules(ARCHS["deepseek-7b"], mesh).param_specs(shapes),
        mesh)
    assert total / 256 <= held < total / 250

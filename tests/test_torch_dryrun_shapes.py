"""The dry-run's shapes held against the JAX package at full size: the
port's ``param_shapes`` (the param tree as meta tensors), its
``opt_state_shapes`` and its ``input_specs`` / ``cache_spec`` equal the
reference's ``jax.eval_shape`` trees, leaf path by leaf path, in shape and
dtype, for every architecture and every (arch x shape) cell.  Nothing is
allocated on either side."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import shape_applicable as jax_applicable
from repro.models import input_specs as jax_input_specs
from repro.models import param_shapes as jax_param_shapes
from repro.train import opt_state_shapes as jax_opt_state_shapes
from repro_torch.configs import ARCHS, SHAPES, smoke_variant
from repro_torch.models import init_model, input_specs, param_shapes
from repro_torch.train import opt_init, opt_state_shapes
from repro_torch.tree import tree_items, tree_leaves

CELLS = [(a, s) for a in JAX_ARCHS for s in JAX_SHAPES
         if jax_applicable(JAX_ARCHS[a], JAX_SHAPES[s])[0]]


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _assert_same_leaves(got, want):
    """``got`` (a port tree of meta tensors or TensorSpecs) against
    ``want`` (a JAX tree of ShapeDtypeStructs)."""
    got = dict(tree_items(got))
    want = _jax_leaves(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == str(np.dtype(w.dtype)), \
            path


def test_cells_are_the_references_33():
    assert len(CELLS) == 33


@pytest.mark.parametrize("tp_pad", [1, 16])
@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_param_shapes_equal_jax_at_full_size(arch, tp_pad):
    tree = param_shapes(ARCHS[arch], tp_pad=tp_pad)
    assert all(p.device.type == "meta" for p in tree_leaves(tree))
    _assert_same_leaves(tree, jax_param_shapes(JAX_ARCHS[arch], tp_pad))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_opt_state_shapes_equal_jax_at_full_size(arch, opt):
    state = opt_state_shapes(opt, param_shapes(ARCHS[arch]))
    assert all(p.device.type == "meta" for p in tree_leaves(state))
    _assert_same_leaves(state, jax_opt_state_shapes(
        opt, jax_param_shapes(JAX_ARCHS[arch])))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_cache_specs_equal_jax(arch, shape):
    got = input_specs(ARCHS[arch], SHAPES[shape])
    want = jax_input_specs(JAX_ARCHS[arch], JAX_SHAPES[shape])
    _assert_same_leaves(got, want)
    if SHAPES[shape].kind == "decode":
        assert set(got["cache"]) == set(want["cache"])


def test_param_shapes_match_a_drawn_tree_and_draw_nothing():
    """At smoke size the meta tree has the drawn tree's leaves, and making
    it leaves the generator's state untouched (nothing is drawn)."""
    cfg = smoke_variant(ARCHS["recurrentgemma-9b"])
    gen = torch.Generator().manual_seed(0)
    drawn = init_model(gen, cfg, device="cpu")
    before = gen.get_state()
    shapes = dict(tree_items(param_shapes(cfg)))
    assert torch.equal(gen.get_state(), before)
    for path, p in tree_items(drawn):
        assert (shapes[path].shape, shapes[path].dtype) == (p.shape, p.dtype)


def test_init_model_keeps_its_generator_check():
    """The meta path takes no generator; a real generator still has to lie
    on the device the params are made on."""
    cfg = smoke_variant(ARCHS["deepseek-7b"])
    with pytest.raises(ValueError):
        init_model(torch.Generator(), cfg, device="meta")


def test_opt_state_shapes_refuses_real_tensors():
    params = {"w": torch.zeros(4, 4)}
    with pytest.raises(ValueError):
        opt_state_shapes("adamw", params)
    state = opt_init("adamw", params)
    assert state["m"]["w"].device.type == "cpu"

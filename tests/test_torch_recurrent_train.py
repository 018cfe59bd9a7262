"""The port's recurrent families' training path held against the JAX
package on the CPU at smoke size: mamba2-370m (Mamba2 SSD) and
recurrentgemma-9b (the Griffin hybrid) gradients of the LM loss through
both hybrid stacks, remat against no remat, and one AdamW, one Adafactor
and one int8-compressed ``make_train_step`` step (serving:
test_torch_recurrent_model.py).  JAX params and optimizer states are
converted and the batches are numpy arrays from a seed, so both packages
compute on the same numbers; the Pallas kernel runs in interpret mode."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import forward_train as jax_forward_train
from repro.models import init_model as jax_init
from repro.train import lm_loss as jax_lm_loss
from repro.train import make_train_step as jax_make_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.train import OptConfig, loss_and_grads, make_train_step

SSM, HYBRID = "mamba2-370m", "recurrentgemma-9b"
B, S = 2, 24
# fp32 on both sides; the differences are summation order only.  The LM
# loss and gradients as tests/test_torch_train_grads.py holds them.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-4


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _setup(arch, n_layers, seed=0, **kw):
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), n_layers=n_layers,
                               **kw)
    tcfg = dataclasses.replace(smoke_variant(ARCHS[arch]), n_layers=n_layers,
                               **kw)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(_tree_np(jparams), "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------ gradients ------------------------------

@functools.lru_cache(maxsize=None)
def _grads(arch, n_layers, impl, remat=False):
    jcfg, tcfg, jparams, tparams = _setup(arch, n_layers, attn_impl=impl,
                                          remat=remat)
    tokens = _tokens(jcfg, (B, S), 7)

    def jloss(p):
        h, aux = jax_forward_train(p, jcfg, {"tokens": jnp.asarray(tokens)})
        return jax_lm_loss(p, jcfg, h, jnp.asarray(tokens), aux)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tl, _, tg = loss_and_grads(tparams, tcfg,
                               {"tokens": torch.from_numpy(tokens)})
    for p in jax.tree.leaves(tparams):            # params left as found
        assert not p.requires_grad and p.grad is None
    return float(jl), _tree_np(jg), float(tl), tg


@pytest.mark.parametrize("arch,n_layers,impl", [
    (SSM, 3, "flash"), (HYBRID, 3, "flash_pallas"), (HYBRID, 5, "flash")])
def test_loss_grads_match_jax(arch, n_layers, impl):
    """Every leaf of both hybrid stacks gets its gradient, through the
    per-layer flush of each stack."""
    jl, jg, tl, tg = _grads(arch, n_layers, impl)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    want, got = dict(_flat(jg)), dict(_flat(tg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert torch.isfinite(got[path]).all(), path
        _close(got[path], w, GRAD_TOL, str(path))
        if path[0] != "embed" and path[-1] not in ("b_r", "b_i"):
            assert float(got[path].abs().sum()) > 0, path


@pytest.mark.parametrize("arch,n_layers", [(SSM, 3), (HYBRID, 5)])
def test_remat_matches_no_remat(arch, n_layers):
    """Checkpointed SSM layers, and hybrid super-blocks and leftover rec
    layers, recompute the same forward: identical grads."""
    impl = "flash_pallas"
    _, _, tl0, tg0 = _grads(arch, n_layers, impl)
    _, _, tl1, tg1 = _grads(arch, n_layers, impl, remat=True)
    assert tl0 == tl1
    for (path, a), (_, b) in zip(_flat(tg0), _flat(tg1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))


# ----------------------------- train steps -----------------------------

def _assert_params_close(tp, jp, bad_frac, lr=OptConfig().lr, steps=1):
    """As tests/test_torch_train.py holds the dense steps: elementwise
    within 1e-5 + 1e-4 relative but for at most ``bad_frac`` of the
    elements, none further off than the optimizer's largest step."""
    n_all = n_bad = 0
    got = dict(_flat(tp))
    for path, w in _flat(jp):
        diff = np.abs(_np(got[path]) - w)
        n_all += diff.size
        n_bad += int((diff > 1e-5 + 1e-4 * np.abs(w)).sum())
        assert diff.max() <= 2 * lr * steps, (path, diff.max())
    assert n_bad / n_all <= bad_frac, n_bad / n_all


@pytest.mark.parametrize("optimizer,compression", [
    ("adamw", False), ("adafactor", False), ("adafactor", True)])
@pytest.mark.parametrize("arch,n_layers", [(SSM, 3), (HYBRID, 5)])
def test_train_step_matches_jax(arch, n_layers, optimizer, compression):
    """One ``make_train_step`` step; with int8 compression at most 0.5 % of
    the updated elements may leave the elementwise tolerance (a value
    crossing a rounding boundary of the int8 grid), else 0.1 %."""
    jcfg, tcfg, jparams, tparams = _setup(
        arch, n_layers, attn_impl="flash_pallas", optimizer=optimizer,
        grad_compression=compression)
    jstate = jopt.opt_init(optimizer, jparams)
    tstate = opt_state_from_numpy(_tree_np(jstate), "cpu")
    tokens = _tokens(jcfg, (B, S), 10)
    jparams, jstate, jm = jax.jit(jax_make_train_step(jcfg))(
        jparams, jstate, {"tokens": jnp.asarray(tokens)})
    tparams, tstate, tm = make_train_step(tcfg, device="cpu")(
        tparams, tstate, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    _assert_params_close(tparams, _tree_np(jparams),
                         bad_frac=5e-3 if compression else 1e-3)
    assert int(tstate["count"]) == int(jstate["count"]) == 1

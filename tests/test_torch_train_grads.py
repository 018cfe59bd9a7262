"""The port's ``forward_train`` gradient path held against the JAX package
on the CPU at smoke size: gradients of the LM loss for three dense configs
(MHA, GQA with partial rotary, SWA) and the three attention
implementations, and remat on against off.  JAX params and numpy batches
are converted, so both packages compute on the same numbers; the Pallas
kernels run in interpret mode."""
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
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.train import loss_and_grads

ARCH_IDS = ["deepseek-7b", "chatglm3-6b", "h2o-danube-1.8b"]
IMPLS = ["flash", "flash_cvjp", "flash_pallas"]
B, S = 2, 32
# fp32 on both sides; the differences are summation order only.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _assert_tree_close(got, want, **tol):
    want, got = dict(_flat(want)), dict(_flat(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == np.shape(w), path
        np.testing.assert_allclose(got[path].detach().float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=str(path), **tol)


def _cfgs(arch, impl, **kw):
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), attn_impl=impl,
                                **kw),
            dataclasses.replace(smoke_variant(ARCHS[arch]), attn_impl=impl,
                                **kw))


def _tokens(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------- forward_train grads -------------------------

@functools.lru_cache(maxsize=None)
def _grads(arch, impl, remat=False):
    jcfg, tcfg = _cfgs(arch, impl, remat=remat)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(_tree_np(jparams), "cpu")
    tokens = _tokens(jcfg, len(arch))

    def jloss(p):
        h, aux = jax_forward_train(p, jcfg, {"tokens": jnp.asarray(tokens)})
        return jax_lm_loss(p, jcfg, h, jnp.asarray(tokens), aux)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tl, _, tg = loss_and_grads(tparams, tcfg,
                               {"tokens": torch.from_numpy(tokens)})
    for p in jax.tree.leaves(tparams):            # params left as found
        assert not p.requires_grad and p.grad is None
    return float(jl), _tree_np(jg), float(tl), tg


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_grads_match_jax(arch, impl):
    jl, jg, tl, tg = _grads(arch, impl)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _assert_tree_close(tg, jg, **GRAD_TOL)
    # attention's own weights get a gradient through attention
    for w in ("wq", "wk", "wv"):
        assert float(tg["blocks"]["attn"][w].abs().sum()) > 0


@pytest.mark.parametrize("impl", ["flash", "flash_pallas"])
def test_remat_matches_no_remat(impl):
    """Checkpointed layers recompute the same forward: identical grads."""
    _, _, tl0, tg0 = _grads("deepseek-7b", impl, remat=False)
    _, _, tl1, tg1 = _grads("deepseek-7b", impl, remat=True)
    assert tl0 == tl1
    for (path, a), (_, b) in zip(_flat(tg0), _flat(tg1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))


def test_remat_reruns_the_forward_kernel_path():
    """With remat each layer's attention forward runs again in backward;
    on the CPU the wrapper takes its twin, so no launch is counted, but
    the flash_pallas Function runs 2x per layer."""
    jcfg, tcfg = _cfgs("deepseek-7b", "flash_pallas", remat=True)
    tparams = params_from_numpy(_tree_np(jax_init(jax.random.PRNGKey(0),
                                                  jcfg)), "cpu")
    calls = []
    orig = fa.flash_fwd_reference

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    fa.flash_fwd_reference = counting
    try:
        loss_and_grads(tparams, tcfg,
                       {"tokens": torch.from_numpy(_tokens(jcfg, 0))})
    finally:
        fa.flash_fwd_reference = orig
    assert len(calls) == 2 * tcfg.n_layers

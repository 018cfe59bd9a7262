"""The port's training slice held against the JAX package on the CPU at smoke
size: the chunked LM loss, AdamW and Adafactor over several steps, and
whole ``make_train_step`` steps (loss, grad norm, updated params and
state); ``forward_train``'s gradients are in test_torch_train_grads.py.  JAX params, optimizer states
and numpy batches are converted, so both packages compute on the same
numbers; the Pallas kernels run in interpret mode."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import forward_train as jax_forward_train
from repro.models import init_model as jax_init
from repro.train import chunked_softmax_xent as jax_xent
from repro.train import lm_loss as jax_lm_loss
from repro.train import make_train_step as jax_make_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quantize as qz
from repro_torch.train import (OptConfig, chunked_softmax_xent, lm_loss,
                               make_eval_step, make_train_step, opt_init,
                               opt_update)

IMPLS = ["flash", "flash_cvjp", "flash_pallas"]
B, S = 2, 32
# fp32 on both sides; the differences are summation order only.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


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


def _assert_tree_close(got, want, **tol):
    want = dict(_flat(want))
    got = dict(_flat(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == np.shape(w), path
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   err_msg=str(path), **tol)


def _cfgs(arch, impl, **kw):
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), attn_impl=impl,
                               **kw)
    tcfg = dataclasses.replace(smoke_variant(ARCHS[arch]), attn_impl=impl,
                               **kw)
    return jcfg, tcfg


def _tokens(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------- loss -------------------------------

@pytest.mark.parametrize("S_", [32, 1000, 1536])
def test_chunked_softmax_xent_matches_jax(S_):
    """1000 is not a multiple of 512: the divisor search picks 500."""
    rng = np.random.default_rng(S_)
    d, V = 16, 64
    hidden = rng.normal(size=(2, S_, d)).astype(np.float32)
    emb = {"head": rng.normal(size=(d, V)).astype(np.float32) * 0.3,
           "final_norm": rng.normal(1, 0.1, (d,)).astype(np.float32),
           "tok": np.zeros((V, d), np.float32)}
    labels = rng.integers(0, V, (2, S_)).astype(np.int32)
    mask = (rng.random((2, S_)) > 0.2).astype(np.float32)
    want = jax_xent(jnp.asarray(hidden), jax.tree.map(jnp.asarray, emb),
                    jnp.asarray(labels), jnp.asarray(mask))
    got = chunked_softmax_xent(torch.from_numpy(hidden),
                               params_from_numpy(emb, "cpu"),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_lm_loss_matches_jax():
    jcfg, tcfg = _cfgs("deepseek-7b", "flash")
    jparams = jax_init(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(_tree_np(jparams), "cpu")
    tokens = _tokens(jcfg, 0)
    hidden = np.random.default_rng(2).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    want = jax_lm_loss(jparams, jcfg, jnp.asarray(hidden),
                       jnp.asarray(tokens), jnp.asarray(0.5, jnp.float32))
    got = lm_loss(tparams, tcfg, torch.from_numpy(hidden),
                  torch.from_numpy(tokens), torch.tensor(0.5))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


# ----------------------------- optimizers -----------------------------

def _opt_tree(dtype):
    """Factored stacked (2, 16, 24), stacked norm (2, 24) (factored on the
    stacked leaf), 2-D (16, 24), unfactored (24,) and (1, 24)."""
    rng = np.random.default_rng(3)
    shapes = {"blocks": {"w": (2, 16, 24), "norm": (2, 24)},
              "head": (16, 24), "final_norm": (24,), "row": (1, 24)}
    params = jax.tree.map(lambda s: rng.normal(0, 1, s).astype(dtype),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda s: rng.normal(0, 1e-2, s).astype(dtype),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name,dtype", [("adamw", np.float32),
                                        ("adafactor", np.float32),
                                        ("adafactor", ml_dtypes.bfloat16)])
def test_optimizer_three_steps_match_jax(name, dtype):
    params, grads = _opt_tree(dtype)
    oc = jopt.OptConfig(name=name, lr=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.opt_init(name, jp)
    tp = params_from_numpy(params, "cpu")
    ts = opt_init(name, tp)
    toc = OptConfig(name=name, lr=1e-2)
    for g in grads:
        jp, js = jopt.opt_update(name, jax.tree.map(jnp.asarray, g), js, jp,
                                 oc)
        tp2, ts2 = opt_update(name, params_from_numpy(g, "cpu"), ts, tp, toc)
        assert tp2 is tp and ts2 is ts            # updated in place
    jp, js = _tree_np(jp), _tree_np(js)
    assert int(ts["count"]) == int(js["count"]) == 3
    assert ts["count"].dtype == torch.int32
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == np.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    _assert_tree_close(tp, jp, **tol)
    for key in [k for k in js if k not in ("count", "m")]:
        _assert_tree_close(ts[key], js[key], rtol=1e-4, atol=1e-6)
    # bf16 m (Adafactor): one bf16 ulp, 2^-8 relative
    m_tol = dict(rtol=1e-4, atol=1e-6) if name == "adamw" \
        else dict(rtol=8e-3, atol=1e-6)
    _assert_tree_close(ts["m"], js["m"], **m_tol)
    if name == "adafactor":
        # state layout: norm stacked (2, 24) is factored, (24,) is not
        assert tuple(ts["vr"]["blocks"]["norm"].shape) == (2,)
        assert tuple(ts["vc"]["blocks"]["norm"].shape) == (24,)
        assert tuple(ts["vc"]["final_norm"].shape) == (1,)
        # bf16 first moment: bit patterns agree but for rare one-ulp ties
        # from fp32 summation order
        for path, w in _flat(js["m"]):
            g = dict(_flat(ts["m"]))[path]
            assert g.dtype == torch.bfloat16
            bits = g.view(torch.int16).numpy().view(np.uint16)
            differ = np.mean(bits != w.view(np.uint16))
            assert differ <= 0.01, (path, differ)


def test_opt_state_converts_bit_exact():
    params, grads = _opt_tree(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.opt_init("adafactor", jp)
    js = jopt.opt_update("adafactor", jax.tree.map(jnp.asarray, grads[0]),
                         js, jp)[1]
    js = _tree_np(js)
    ts = opt_state_from_numpy(js, "cpu")
    m_w = ts["m"]["blocks"]["w"]
    assert m_w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        m_w.view(torch.int16).numpy().view(np.uint16),
        js["m"]["blocks"]["w"].view(np.uint16))
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 1
    np.testing.assert_array_equal(ts["vr"]["head"].numpy(), js["vr"]["head"])


# ---------------------------- train steps ----------------------------

def _assert_params_close(tp, jp, bad_frac, lr=OptConfig().lr, steps=2):
    """Updated params: elementwise within 1e-5 + 1e-4 relative but for at
    most ``bad_frac`` of the elements, and none further off than the
    optimizer's largest possible step (lr per step, plus decay) allows.
    Both optimizers normalise each element's update, so an element whose
    gradient is near zero turns framework noise of ~1e-7 into a visible
    difference of its step; the loss and grad norm are held tightly."""
    n_all = n_bad = 0
    got = dict(_flat(tp))
    for path, w in _flat(jp):
        g = _np(got[path])
        diff = np.abs(g - w)
        n_all += diff.size
        n_bad += int((diff > 1e-5 + 1e-4 * np.abs(w)).sum())
        assert diff.max() <= 2 * lr * steps, (path, diff.max())
    assert n_bad / n_all <= bad_frac, n_bad / n_all


@functools.lru_cache(maxsize=None)
def _steps(arch, impl, optimizer, compression, n_steps=2):
    jcfg, tcfg = _cfgs(arch, impl, optimizer=optimizer,
                       grad_compression=compression)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(_tree_np(jparams), "cpu")
    jstate = jopt.opt_init(optimizer, jparams)
    tstate = opt_state_from_numpy(_tree_np(jstate), "cpu")
    jstep = jax.jit(jax_make_train_step(jcfg))
    tstep = make_train_step(tcfg, device="cpu")
    jm, tm = [], []
    for i in range(n_steps):
        tokens = _tokens(jcfg, i)
        jparams, jstate, m = jstep(jparams, jstate,
                                   {"tokens": jnp.asarray(tokens)})
        jm.append(_tree_np(m))
        tparams, tstate, m = tstep(tparams, tstate,
                                   {"tokens": torch.from_numpy(tokens)})
        tm.append(m)
    return _tree_np(jparams), _tree_np(jstate), jm, tparams, tstate, tm


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_step_matches_jax(optimizer):
    jp, js, jm, tp, ts, tm = _steps("deepseek-7b", "flash_pallas", optimizer,
                                    False)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(float(t["loss"]), j["loss"], **LOSS_TOL)
        np.testing.assert_allclose(float(t["grad_norm"]), j["grad_norm"],
                                   rtol=1e-4)
        assert float(t["aux_loss"]) == float(j["aux_loss"]) == 0.0
    _assert_params_close(tp, jp, bad_frac=1e-3)
    assert int(ts["count"]) == int(js["count"]) == 2


def test_train_step_with_compression_matches_jax():
    """Compression on: gradient noise of ~1e-7 between the frameworks can
    move a value across a rounding boundary of the int8 grid, which changes
    that element's gradient by one quantization step.  So at most 0.5 % of
    the updated params' elements may leave the elementwise tolerance."""
    jp, js, jm, tp, ts, tm = _steps("deepseek-7b", "flash_pallas",
                                    "adafactor", True)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(float(t["loss"]), j["loss"], **LOSS_TOL)
        np.testing.assert_allclose(float(t["grad_norm"]), j["grad_norm"],
                                   rtol=1e-4)
    _assert_params_close(tp, jp, bad_frac=5e-3)


def test_train_step_compression_counts_launch_free_on_cpu():
    """On the CPU the quantizer's wrappers take their twins: no launch is
    counted, and the loss still falls over steps on a repeated batch."""
    jcfg, tcfg = _cfgs("deepseek-7b", "flash_pallas", optimizer="adafactor",
                       grad_compression=True)
    tparams = params_from_numpy(_tree_np(jax_init(jax.random.PRNGKey(0),
                                                  jcfg)), "cpu")
    state = opt_init("adafactor", tparams)
    step = make_train_step(tcfg, OptConfig(name="adafactor", lr=3e-3),
                           device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(jcfg, 0))}
    before = (qz.QUANT_LAUNCHES, qz.DEQUANT_LAUNCHES, fa.LAUNCHES)
    losses = [float(step(tparams, state, batch)[2]["loss"])
              for _ in range(4)]
    assert (qz.QUANT_LAUNCHES, qz.DEQUANT_LAUNCHES, fa.LAUNCHES) == before
    after = float(make_eval_step(tcfg, device="cpu")(tparams, batch))
    assert np.isfinite(losses).all() and after < losses[0]


def test_train_step_same_loss_across_attn_impls():
    """The port's mirror of the reference test of the same name: one train
    step gives (numerically) the same loss for all three attention
    implementations on a dense smoke config."""
    losses = {}
    for impl in IMPLS:
        jcfg, tcfg = _cfgs("deepseek-7b", impl)
        tparams = params_from_numpy(
            _tree_np(jax_init(jax.random.PRNGKey(0), jcfg)), "cpu")
        state = opt_init(tcfg.optimizer, tparams)
        _, _, m = make_train_step(tcfg, device="cpu")(
            tparams, state, {"tokens": torch.from_numpy(_tokens(jcfg, 9))})
        losses[impl] = float(m["loss"])
    vals = list(losses.values())
    assert max(vals) - min(vals) < 5e-3, losses


def test_eval_step_matches_jax_loss():
    jcfg, tcfg = _cfgs("chatglm3-6b", "flash_pallas")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(_tree_np(jparams), "cpu")
    tokens = _tokens(jcfg, 4)
    h, aux = jax_forward_train(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    want = jax_lm_loss(jparams, jcfg, h, jnp.asarray(tokens), aux)
    got = make_eval_step(tcfg, device="cpu")(
        tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)

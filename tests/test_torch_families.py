"""The configs' seventh family, ``"audio"``, held against the JAX package on
the CPU at smoke size.  No architecture uses it, and neither package has a
branch for it: every dispatch falls through to the dense, token-only stack
(``init_model``, ``forward_train``, ``input_specs``, the cache, prefill,
decode and the steps).  The model is deepseek-7b's smoke with
``family="audio"``; JAX params and numpy tokens are converted, so both
packages compute on the same numbers, and the Pallas kernel runs in
interpret mode.  The tolerances are those of test_torch_layers.py (1e-5),
test_torch_serve.py (1e-4, tokens equal) and test_torch_train.py (loss
1e-5)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import smoke_variant as jax_smoke
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import forward_train as jax_train
from repro.models import init_model as jax_init
from repro.models import input_specs as jax_input_specs
from repro.models import layers as JL
from repro.serve import make_decode_step as jax_decode_step
from repro.serve import make_prefill_step as jax_prefill_step
from repro.train import make_train_step as jax_make_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, ShapeConfig, smoke_variant
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models import (forward_decode, forward_prefill,
                                forward_train, init_model, input_specs,
                                make_inputs)
from repro_torch.models import layers as TL
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.train import make_train_step
from repro_torch.tree import tree_items

ARCH = "deepseek-7b"
IMPLS = ["flash", "flash_pallas"]
B, S, PAD, STEPS = 2, 20, 6, 5
FWD_TOL = dict(rtol=1e-5, atol=1e-5)      # test_torch_layers.py
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)    # test_torch_serve.py
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)     # test_torch_train.py


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _cfgs(impl, **kw):
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[ARCH]), family="audio",
                                attn_impl=impl, **kw),
            dataclasses.replace(smoke_variant(ARCHS[ARCH]), family="audio",
                                attn_impl=impl, **kw))


def _params(jcfg):
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    return jparams, params_from_numpy(_tree_np(jparams), "cpu")


def _tokens(jcfg, seed, n=S + 1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jcfg.vocab_size, (B, n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _serve(impl):
    """Everything both packages compute when serving, once per impl."""
    jcfg, tcfg = _cfgs(impl)
    jparams, tparams = _params(jcfg)
    prompts = _tokens(jcfg, 7)
    jb = {"tokens": jnp.asarray(prompts[:, :S])}
    tb = {"tokens": torch.from_numpy(prompts[:, :S])}
    nxt = prompts[:, S:]
    r = {}

    jh, jc = jax_prefill(jparams, jcfg, jb, pad_to=S + PAD)
    th, tc = forward_prefill(tparams, tcfg, tb, pad_to=S + PAD)
    r["prefill"] = (jh, jc, th, {k: v.clone() for k, v in tc.items()})
    jh2, jc2 = jax_decode(jparams, jcfg, jc, jnp.asarray(nxt),
                          jnp.asarray(S, jnp.int32))
    th2, tc2 = forward_decode(tparams, tcfg, tc, torch.from_numpy(nxt), S)
    r["decode"] = (jh2, jc2, th2, tc2)

    jpre = jax.jit(jax_prefill_step(jcfg, pad_to=S + PAD))
    jdec = jax.jit(jax_decode_step(jcfg))
    tpre = make_prefill_step(tcfg, pad_to=S + PAD, device="cpu")
    tdec = make_decode_step(tcfg, device="cpu")
    jl, jcache = jpre(jparams, jb)
    tl, tcache = tpre(tparams, tb)
    jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    jtoks, ttoks, jlog, tlog = [jtok], [ttok], [jl], [tl]
    for t in range(STEPS):
        jtok, jlt, jcache = jdec(jparams, jcache, jtok,
                                 jnp.asarray(S + t, jnp.int32))
        ttok, tlt, tcache = tdec(tparams, tcache, ttok, S + t)
        jtoks.append(jtok)
        ttoks.append(ttok)
        jlog.append(jlt)
        tlog.append(tlt)
    r["greedy"] = (np.concatenate([np.asarray(x) for x in jtoks], 1),
                   torch.cat(ttoks, 1).numpy(), jlog, tlog)
    return r


@pytest.mark.parametrize("impl", IMPLS)
def test_audio_forward_train_matches_jax(impl):
    """Hidden states and logits of the full forward, and no aux loss."""
    jcfg, tcfg = _cfgs(impl)
    jparams, tparams = _params(jcfg)
    tokens = _tokens(jcfg, 3)
    jh, jaux = jax_train(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    th, taux = forward_train(tparams, tcfg,
                             {"tokens": torch.from_numpy(tokens)})
    assert tuple(th.shape) == tuple(jh.shape) == (B, S + 1, tcfg.d_model)
    np.testing.assert_allclose(_np(th), np.asarray(jh), **FWD_TOL)
    np.testing.assert_allclose(
        _np(TL.lm_logits(tparams["embed"], th)),
        np.asarray(JL.lm_logits(jparams["embed"], jh)), **FWD_TOL)
    assert float(taux) == float(jaux) == 0.0


def test_audio_builds_the_dense_stack():
    """Both packages build the dense param tree for "audio", and the port
    gives it the dense family's hidden states bit for bit."""
    jcfg, tcfg = _cfgs("flash")
    jparams, _ = _params(jcfg)
    want = {path: leaf.shape for path, leaf in _jax_leaves(jparams).items()}
    tparams = init_model(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    got = {path: tuple(p.shape) for path, p in tree_items(tparams)}
    assert got == want
    assert sorted(tparams) == ["blocks", "embed"]
    tokens = torch.from_numpy(_tokens(jcfg, 4))
    dense = dataclasses.replace(tcfg, family="dense")
    assert torch.equal(forward_train(tparams, tcfg, {"tokens": tokens})[0],
                       forward_train(tparams, dense, {"tokens": tokens})[0])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_audio_input_specs_and_inputs_match_jax(kind):
    """``input_specs`` (the decode cache included) equals the reference's
    leaf by leaf, and ``make_inputs`` draws tensors of those specs."""
    jcfg, tcfg = _cfgs("flash")
    want = _jax_leaves(jax_input_specs(jcfg,
                                       JaxShapeConfig("smoke", 16, 2, kind)))
    shape = ShapeConfig("smoke", 16, 2, kind)
    specs = dict(tree_items(input_specs(tcfg, shape)))
    assert sorted(specs) == sorted(want)
    for path, w in want.items():
        assert tuple(specs[path].shape) == tuple(w.shape), path
        assert str(specs[path].dtype).removeprefix("torch.") \
            == str(np.dtype(w.dtype)), path
    drawn = dict(tree_items(make_inputs(torch.Generator().manual_seed(0),
                                        tcfg, shape, device="cpu")))
    assert {p: (tuple(t.shape), t.dtype) for p, t in drawn.items()} \
        == {p: (tuple(s.shape), s.dtype) for p, s in specs.items()}


@pytest.mark.parametrize("impl", IMPLS)
def test_audio_prefill_matches_jax(impl):
    jh, jc, th, tc = _serve(impl)["prefill"]
    np.testing.assert_allclose(_np(th), np.asarray(jh), **SERVE_TOL)
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   **SERVE_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_audio_decode_matches_jax(impl):
    jh, jc, th, tc = _serve(impl)["decode"]
    np.testing.assert_allclose(_np(th), np.asarray(jh), **SERVE_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   **SERVE_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_audio_greedy_serving_matches_jax(impl):
    """The prefill and decode steps' logits, and the greedy tokens equal."""
    jtoks, ttoks, jlog, tlog = _serve(impl)["greedy"]
    assert ttoks.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(ttoks, jtoks)
    for j, t in zip(jlog, tlog):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(_np(t), np.asarray(j), **SERVE_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_audio_adamw_train_step_matches_jax(impl):
    """One AdamW step: the loss at 1e-5, the grad norm at 1e-4."""
    jcfg, tcfg = _cfgs(impl, optimizer="adamw")
    jparams, tparams = _params(jcfg)
    jstate = jopt.opt_init("adamw", jparams)
    tstate = opt_state_from_numpy(_tree_np(jstate), "cpu")
    tokens = _tokens(jcfg, 5, n=S)
    _, _, jm = jax.jit(jax_make_train_step(jcfg))(
        jparams, jstate, {"tokens": jnp.asarray(tokens)})
    _, tstate, tm = make_train_step(tcfg, device="cpu")(
        tparams, tstate, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert int(tstate["count"]) == 1

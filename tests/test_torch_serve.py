"""The port's serving slice held against the JAX package end to end, on the
CPU at smoke size: forward_prefill / forward_decode (hidden and ring
cache), the make_prefill_step / make_decode_step logits, and an 8-token
greedy loop as examples/serve_kvcache.py drives it, for three dense
configs (MHA, GQA with partial rotary, SWA ring) and both attention
implementations.  JAX params are converted, so both compute on the same
numbers; the Pallas kernel runs in interpret mode."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import forward_train as jax_train
from repro.models import init_model as jax_init
from repro.serve import make_decode_step as jax_decode_step
from repro.serve import make_prefill_step as jax_prefill_step
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.models import (forward_decode, forward_prefill,
                                forward_train, init_model)
from repro_torch.serve import make_decode_step, make_prefill_step

ARCH_IDS = ["deepseek-7b", "chatglm3-6b", "h2o-danube-1.8b"]
IMPLS = ["flash", "flash_pallas"]
B, S, PAD, STEPS = 2, 28, 8, 8    # h2o's smoke window is 32: decode wraps
# fp32 on both sides; differences are summation order only.
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _run(arch, impl, dtype="float32"):
    """Everything both packages compute for one config, once per module."""
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), attn_impl=impl,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(smoke_variant(ARCHS[arch]), attn_impl=impl,
                               param_dtype=dtype)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(_tree_np(jparams), "cpu")
    rng = np.random.default_rng(len(arch))
    prompts = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(prompts[:, :S])}
    tb = {"tokens": torch.from_numpy(prompts[:, :S])}
    nxt = prompts[:, S:]
    r = {"cfg": tcfg}

    # forward_prefill / forward_decode
    jh, jc = jax.jit(functools.partial(jax_prefill, cfg=jcfg,
                                       pad_to=S + PAD))(jparams, batch=jb)
    th, tc = forward_prefill(tparams, tcfg, tb, pad_to=S + PAD)
    r["prefill"] = (jh, jc, th, {k: v.clone() for k, v in tc.items()})
    jh2, jc2 = jax.jit(functools.partial(jax_decode, cfg=jcfg))(
        jparams, cache=jc, tokens=jnp.asarray(nxt),
        pos=jnp.asarray(S, jnp.int32))
    th2, tc2 = forward_decode(tparams, tcfg, tc, torch.from_numpy(nxt), S)
    r["decode"] = (jh2, jc2, th2, tc2)

    # forward_train on S+1 tokens: the full-forward side of the identity
    jfull, _ = jax_train(jparams, jcfg, {"tokens": jnp.asarray(prompts)})
    tfull, _ = forward_train(tparams, tcfg,
                             {"tokens": torch.from_numpy(prompts)})
    r["train"] = (jfull, tfull)

    # step factories and the greedy loop
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
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_prefill_matches_jax(arch, impl):
    jh, jc, th, tc = _run(arch, impl)["prefill"]
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_decode_matches_jax(arch, impl):
    jh, jc, th, tc = _run(arch, impl)["decode"]
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_matches_jax(arch, impl):
    jfull, tfull = _run(arch, impl)["train"]
    np.testing.assert_allclose(_np(tfull), np.asarray(jfull), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_logits_match_jax(arch, impl):
    _, _, jlog, tlog = _run(arch, impl)["greedy"]
    assert len(jlog) == len(tlog) == STEPS + 1
    for j, t in zip(jlog, tlog):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_greedy_tokens_identical_to_jax(arch, impl):
    jtoks, ttoks, _, _ = _run(arch, impl)["greedy"]
    assert ttoks.dtype == np.int32 and ttoks.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(ttoks, jtoks)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_matches_full_forward(arch, impl):
    """logits(prefill S tokens, decode token S) == logits(forward S+1), the
    rule and tolerance of tests/test_models.py."""
    r = _run(arch, impl)
    _, tfull = r["train"]
    _, _, th2, _ = r["decode"]
    np.testing.assert_allclose(_np(th2[:, 0]), _np(tfull[:, -1]),
                               rtol=0.05, atol=0.05)


def test_bf16_serving_matches_jax():
    """bf16 params cross the converter bit-exactly; the two frameworks then
    round bf16 at different places (XLA fuses elementwise chains in fp32,
    torch rounds after each op), so logits agree to a few bf16 ulps of
    their scale: relative norm error <= 3e-2."""
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS["deepseek-7b"]),
                               attn_impl="flash_pallas",
                               param_dtype="bfloat16")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(_tree_np(jparams), "cpu")
    wq_j = np.asarray(jparams["blocks"]["attn"]["wq"]).view(np.uint16)
    wq_t = tparams["blocks"]["attn"]["wq"]
    assert wq_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq_t.view(torch.int16).numpy()
                                  .view(np.uint16), wq_j)
    r = _run("deepseek-7b", "flash_pallas", "bfloat16")
    _, _, jlog, tlog = r["greedy"]
    for j, t in zip(jlog, tlog):
        j = np.asarray(j, np.float32)
        rel = np.linalg.norm(_np(t) - j) / np.linalg.norm(j)
        assert rel <= 3e-2, rel


def test_init_model_draws_full_param_tree():
    """The port's init builds the JAX pytree's keys and shapes."""
    jcfg = jax_smoke(JAX_ARCHS["chatglm3-6b"])
    tcfg = smoke_variant(ARCHS["chatglm3-6b"])
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jax_init(jax.random.PRNGKey(0), jcfg))
    tparams = init_model(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)
    assert shapes(tparams) == jshapes


def test_swa_prompt_longer_than_window_matches_jax():
    """h2o's smoke window is 32; a 40-token prompt keeps the last 32
    positions in slots 0..31 while decode writes slot pos % 32.  The port
    reproduces the reference here too (both break the prefill-then-decode
    identity once the prompt exceeds the window: ROADMAP Queue 3)."""
    arch, S_long = "h2o-danube-1.8b", 40
    jcfg = jax_smoke(JAX_ARCHS[arch])
    tcfg = smoke_variant(ARCHS[arch])
    jparams = jax_init(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(_tree_np(jparams), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S_long + 1)).astype(np.int32)
    jh, jc = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(prompts[:, :-1])})
    th, tc = forward_prefill(tparams, tcfg,
                             {"tokens": torch.from_numpy(prompts[:, :-1])})
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    assert tc["k"].shape[2] == jcfg.swa_window
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **TOL)
    jh2, _ = jax_decode(jparams, jcfg, jc, jnp.asarray(prompts[:, -1:]),
                        jnp.asarray(S_long, jnp.int32))
    th2, _ = forward_decode(tparams, tcfg, tc,
                            torch.from_numpy(prompts[:, -1:]), S_long)
    np.testing.assert_allclose(_np(th2), np.asarray(jh2), **TOL)

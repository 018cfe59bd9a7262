"""The port's recurrent families held against the JAX package end to end on
the CPU at smoke size: mamba2-370m (Mamba2 SSD) and recurrentgemma-9b (the
Griffin hybrid: RG-LRU layers and local MQA attention), at 3 layers (one
hybrid super-block) and 5 (a super-block and two leftover rec layers), the
hybrid with both attention implementations (the Pallas kernel in
interpret mode).  Checked: the param tree, ``forward_train``, prefill
hidden states and every cache leaf, decode, decode against the full
forward, the serve steps' logits and 8 greedy tokens, and the hybrid's
ring-cache fault past the window, reproduced (gradients and train steps:
test_torch_recurrent_train.py).  JAX params are converted and the batches
are numpy arrays from a seed, so both packages compute on the same
numbers."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import cache_spec as jax_cache_spec
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import init_model as jax_init
from repro.serve import make_decode_step as jax_decode_step
from repro.serve import make_prefill_step as jax_prefill_step
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.models import (cache_spec, forward_decode, forward_prefill,
                                forward_train, init_model)
from repro_torch.serve import make_decode_step, make_prefill_step

SSM, HYBRID = "mamba2-370m", "recurrentgemma-9b"
# (arch, n_layers, attn_impl); the SSM has no attention
CFGS = [(SSM, 3, "flash"), (SSM, 5, "flash"),
        (HYBRID, 3, "flash"), (HYBRID, 3, "flash_pallas"),
        (HYBRID, 5, "flash"), (HYBRID, 5, "flash_pallas")]
# S + PAD is the hybrid's smoke window (32): every decode position fits it
B, S, PAD, STEPS = 2, 24, 8, 8
# fp32 on both sides; the differences are summation order only (the scan:
# reassociation).  Hidden states, caches and logits 1e-5 relative plus
# 1e-5 of the tensor's largest |value|.
TOL = 1e-5
# prefill + decode vs the full forward: tests/test_models.py's 0.05
DECODE_TOL = 0.05


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


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _cfgs(arch, n_layers, **kw):
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[arch]),
                                n_layers=n_layers, **kw),
            dataclasses.replace(smoke_variant(ARCHS[arch]),
                                n_layers=n_layers, **kw))


def _setup(arch, n_layers, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, n_layers, **kw)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(_tree_np(jparams), "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------ the tree ------------------------------

@pytest.mark.parametrize("n_layers", [3, 5])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_init_model_tree_matches_jax(arch, n_layers):
    """Keys, shapes and dtypes in bf16: the SSM's one stack, the hybrid's
    rec and local-attention stacks (2 and 1 at 3 layers, 4 and 1 at 5)."""
    jcfg, tcfg = _cfgs(arch, n_layers, param_dtype="bfloat16")
    want = dict(_flat(jax.eval_shape(
        lambda: jax_init(jax.random.PRNGKey(0), jcfg))))
    got = dict(_flat(init_model(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert str(got[path].dtype).split(".")[1] == str(w.dtype), path
    if arch == HYBRID:
        assert got[("rec_blocks", "norm1")].shape[0] == n_layers - 1
        assert got[("attn_blocks", "norm1")].shape[0] == 1


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_cache_spec_matches_jax_at_full_width(arch):
    """mamba2: 48 fp32 (4, 32, 128, 64) states and bf16 conv tails, 204 MB
    for 4 rows; recurrentgemma: 26 fp32 RG-LRU states and bf16 conv tails,
    12 local k/v caches of min(S, 2048) slots of one 256-wide head."""
    cfg = ARCHS[arch]
    for seq in (1056, 4096):
        want = jax_cache_spec(JAX_ARCHS[arch], seq, 4)
        got = cache_spec(cfg, seq, 4)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
    spec = cache_spec(cfg, 1056, 4)
    if arch == SSM:
        nbytes = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                     for s in spec.values())
        assert nbytes == 203_980_800
    else:
        assert spec["k"].shape == (12, 4, 1056, 1, 256)
        assert cache_spec(cfg, 4096, 4)["k"].shape == (12, 4, 2048, 1, 256)


# --------------------------- forward_train ---------------------------

@functools.lru_cache(maxsize=None)
def _serve(arch, n_layers, impl):
    """Everything both packages compute for one config, once per module."""
    jcfg, tcfg, jparams, tparams = _setup(arch, n_layers, seed=3,
                                          attn_impl=impl)
    prompts = _tokens(jcfg, (B, S + 1), n_layers + len(impl))
    jb = {"tokens": jnp.asarray(prompts[:, :S])}
    tb = {"tokens": torch.from_numpy(prompts[:, :S])}
    nxt = prompts[:, S:]
    r = {}
    jfull, jaux = jax_forward_train(jparams, jcfg,
                                    {"tokens": jnp.asarray(prompts)})
    tfull, taux = forward_train(tparams, tcfg,
                                {"tokens": torch.from_numpy(prompts)})
    r["train"] = (jfull, jaux, tfull, taux)
    jh, jc = jax.jit(functools.partial(jax_prefill, cfg=jcfg,
                                       pad_to=S + PAD))(jparams, batch=jb)
    th, tc = forward_prefill(tparams, tcfg, tb, pad_to=S + PAD)
    r["prefill"] = (jh, jc, th, {k: v.clone() for k, v in tc.items()})
    jh2, jc2 = jax.jit(functools.partial(jax_decode, cfg=jcfg))(
        jparams, cache=jc, tokens=jnp.asarray(nxt),
        pos=jnp.asarray(S, jnp.int32))
    th2, tc2 = forward_decode(tparams, tcfg, tc, torch.from_numpy(nxt), S)
    r["decode"] = (jh2, jc2, th2, tc2, tc)

    jpre = jax.jit(jax_prefill_step(jcfg, pad_to=S + PAD))
    jdec = jax.jit(jax_decode_step(jcfg))
    tpre = make_prefill_step(tcfg, pad_to=S + PAD, device="cpu")
    tdec = make_decode_step(tcfg, device="cpu")
    jl, jcache = jpre(jparams, jb)
    tl, tcache = tpre(tparams, tb)
    jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    jlog, tlog, jtoks, ttoks = [jl], [tl], [jtok], [ttok]
    for t in range(STEPS):
        jtok, jlt, jcache = jdec(jparams, jcache, jtok,
                                 jnp.asarray(S + t, jnp.int32))
        ttok, tlt, tcache = tdec(tparams, tcache, ttok, S + t)
        jlog.append(jlt)
        tlog.append(tlt)
        jtoks.append(jtok)
        ttoks.append(ttok)
    r["steps"] = (jlog, tlog, np.concatenate([np.asarray(t) for t in jtoks],
                                             1), torch.cat(ttoks, 1).numpy())
    return r


@pytest.mark.parametrize("arch,n_layers,impl", CFGS)
def test_forward_train_matches_jax(arch, n_layers, impl):
    jfull, jaux, tfull, taux = _serve(arch, n_layers, impl)["train"]
    _close(tfull, jfull)
    assert float(taux) == float(jaux) == 0.0


# ------------------------- prefill and decode -------------------------

@pytest.mark.parametrize("arch,n_layers,impl", CFGS)
def test_prefill_matches_jax(arch, n_layers, impl):
    """Hidden states and every cache leaf, in the reference's layer order
    (the hybrid's rec leaves flattened through the super-block map)."""
    jh, jc, th, tc = _serve(arch, n_layers, impl)["prefill"]
    _close(th, jh, name="prefill hidden")
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype)
        _close(tc[name], jc[name], name=f"prefill {name}")


@pytest.mark.parametrize("arch,n_layers,impl", CFGS)
def test_decode_matches_jax_and_updates_the_cache_in_place(arch, n_layers,
                                                           impl):
    jh2, jc2, th2, tc2, tc = _serve(arch, n_layers, impl)["decode"]
    _close(th2, jh2, name="decode hidden")
    assert tc2 is tc
    for name in jc2:
        _close(tc2[name], jc2[name], name=f"decode {name}")


@pytest.mark.parametrize("arch,n_layers,impl", CFGS)
def test_prefill_then_decode_matches_full_forward(arch, n_layers, impl):
    """The reference's test of the same name (tests/test_models.py): decode
    at position S against the full forward's last row."""
    r = _serve(arch, n_layers, impl)
    tfull = r["train"][2]
    th2 = r["decode"][2]
    np.testing.assert_allclose(_np(th2[:, 0]), _np(tfull[:, -1]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("arch,n_layers,impl", CFGS)
def test_serve_step_logits_and_tokens_match_jax(arch, n_layers, impl):
    jlog, tlog, jtoks, ttoks = _serve(arch, n_layers, impl)["steps"]
    assert len(jlog) == len(tlog) == STEPS + 1
    for j, t in zip(jlog, tlog):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, name="logits")
    assert ttoks.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(ttoks, jtoks)


@pytest.mark.parametrize("n_layers", [3, 5])
def test_hybrid_prompt_longer_than_the_window_matches_jax(n_layers):
    """The SWA ring-cache fault (ROADMAP Queue 3) reaches the hybrid's local
    caches: a 40-token prompt against window 32 keeps the last 32
    positions in slots 0..31 while decode writes slot pos % 32.  The port
    reproduces the reference here too: its decode equals JAX's, and both
    miss the full forward by more than the 0.05 of the identity."""
    S_long = 40
    jcfg, tcfg, jparams, tparams = _setup(HYBRID, n_layers, seed=3)
    prompts = _tokens(jcfg, (B, S_long + 1), 0)
    jh, jc = jax_prefill(jparams, jcfg,
                         {"tokens": jnp.asarray(prompts[:, :-1])})
    th, tc = forward_prefill(tparams, tcfg,
                             {"tokens": torch.from_numpy(prompts[:, :-1])})
    assert tc["k"].shape[2] == jcfg.local_window == 32
    for name in jc:
        _close(tc[name], jc[name], name=f"prefill {name}")
    jh2, _ = jax_decode(jparams, jcfg, jc, jnp.asarray(prompts[:, -1:]),
                        jnp.asarray(S_long, jnp.int32))
    th2, _ = forward_decode(tparams, tcfg, tc,
                            torch.from_numpy(prompts[:, -1:]), S_long)
    _close(th2, jh2, name="decode hidden")
    jfull, _ = jax_forward_train(jparams, jcfg,
                                 {"tokens": jnp.asarray(prompts)})
    tfull, _ = forward_train(tparams, tcfg,
                             {"tokens": torch.from_numpy(prompts)})
    _close(tfull, jfull, name="full forward")
    for dec, full in ((_np(th2[:, 0]), _np(tfull[:, -1])),
                      (np.asarray(jh2[:, 0]), np.asarray(jfull[:, -1]))):
        assert float(np.abs(dec - full).max()) > DECODE_TOL

"""The port's MoE family (qwen3-moe-235b-a22b and arctic-480b) held against
the JAX package end to end on the CPU at smoke size: the model tree,
``forward_train``'s hidden states and aux loss, prefill and decode (hidden
and GQA ring caches) and the serve steps' logits, prefill + decode against
the full forward, gradients of the LM loss with and without remat, and
whole ``make_train_step`` steps with Adafactor (its factored state on the
4-D expert leaves) and with int8 gradient compression.  JAX params and
optimizer states are converted and the batches are numpy arrays from a
seed, so both packages compute on the same numbers; the Pallas kernel runs
in interpret mode."""
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
from repro.models import forward_train as jax_forward_train
from repro.models import init_model as jax_init
from repro.serve import make_decode_step as jax_decode_step
from repro.serve import make_prefill_step as jax_prefill_step
from repro.train import lm_loss as jax_lm_loss
from repro.train import make_train_step as jax_make_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models import (cache_spec, forward_decode, forward_prefill,
                                forward_train, init_model)
from repro_torch.models import moe as M
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.train import OptConfig, loss_and_grads, make_train_step

ARCH_IDS = ["qwen3-moe-235b-a22b", "arctic-480b"]
IMPLS = ["flash", "flash_pallas"]
B, S, PAD, STEPS = 2, 24, 8, 4
# fp32 on both sides; the differences are summation order only.  Hidden
# states, caches and logits: 1e-5 relative plus 1e-5 of the tensor's
# largest |value| (the experts' 1/sqrt(E) init scale grows the residual
# stream to O(100)); the aux loss 1e-6; the LM loss and gradients as
# tests/test_torch_train_grads.py holds them.
TOL = 1e-5
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-4
# prefill + decode vs the full forward: tests/test_models.py's 0.05, at its
# no-drop capacity factor
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


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), **kw),
            dataclasses.replace(smoke_variant(ARCHS[arch]), **kw))


def _setup(arch, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(_tree_np(jparams), "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------ the tree ------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_model_tree_matches_jax(arch):
    """Keys, shapes and dtypes at smoke width in bf16, and the 4-D stacked
    expert leaves."""
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    want = dict(_flat(jax.eval_shape(
        lambda: jax_init(jax.random.PRNGKey(0), jcfg))))
    got = dict(_flat(init_model(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert str(got[path].dtype).split(".")[1] == str(w.dtype), path
    L, E, d, ff = tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(got[("blocks", "moe", "w_gate")].shape) == (L, E, d, ff)
    assert tuple(got[("blocks", "moe", "w_down")].shape) == (L, E, ff, d)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_spec_is_the_gqa_cache(arch):
    """At full width: qwen3's 4 and arctic's 8 KV heads of 128."""
    cfg = ARCHS[arch]
    spec = cache_spec(cfg, 1056, 4)
    want = (cfg.n_layers, 4, 1056, cfg.n_kv_heads, cfg.head_dim)
    assert spec["k"].shape == spec["v"].shape == want
    assert spec["k"].dtype == torch.bfloat16


# --------------------------- forward_train ---------------------------

@functools.lru_cache(maxsize=None)
def _train(arch, impl):
    jcfg, tcfg, jparams, tparams = _setup(arch, attn_impl=impl)
    tokens = _tokens(jcfg, (B, S), 1)
    jh, jaux = jax_forward_train(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    th, taux = forward_train(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    return jh, jaux, th, taux


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_matches_jax(arch, impl):
    jh, jaux, th, taux = _train(arch, impl)
    _close(th, jh)
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


# ------------------------- prefill and decode -------------------------

@functools.lru_cache(maxsize=None)
def _serve(arch, impl, cf):
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=3, attn_impl=impl,
                                          capacity_factor=cf)
    prompts = _tokens(jcfg, (B, S + 1), len(arch))
    jb, tb = {"tokens": jnp.asarray(prompts[:, :S])}, \
        {"tokens": torch.from_numpy(prompts[:, :S])}
    nxt = prompts[:, S:]
    r = {}
    jh, jc = jax_prefill(jparams, jcfg, jb, pad_to=S + PAD)
    dropped = []
    route = M.route

    def counting_route(*a, **kw):
        routing = route(*a, **kw)
        dropped.append(int((~routing.keep).sum()))
        return routing
    M.route = counting_route
    try:
        th, tc = forward_prefill(tparams, tcfg, tb, pad_to=S + PAD)
    finally:
        M.route = route
    r["prefill"] = (jh, jc, th, {k: v.clone() for k, v in tc.items()})
    r["prefill_dropped"] = dropped
    jh2, jc2 = jax_decode(jparams, jcfg, jc, jnp.asarray(nxt),
                          jnp.asarray(S, jnp.int32))
    th2, tc2 = forward_decode(tparams, tcfg, tc, torch.from_numpy(nxt), S)
    r["decode"] = (jh2, jc2, th2, tc2)
    tfull, _ = forward_train(tparams, tcfg,
                             {"tokens": torch.from_numpy(prompts)})
    r["full"] = (tfull, th2)

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


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_jax(arch, impl, cf):
    """At the default capacity factor prefill drops tokens, as the
    reference's does; at 8 it drops none."""
    r = _serve(arch, impl, cf)
    assert len(r["prefill_dropped"]) == smoke_variant(ARCHS[arch]).n_layers
    assert (sum(r["prefill_dropped"]) > 0) == (cf == 1.25)
    jh, jc, th, tc = r["prefill"]
    _close(th, jh, name="prefill hidden")
    jh2, jc2, th2, tc2 = r["decode"]
    _close(th2, jh2, name="decode hidden")
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        _close(tc[name], jc[name], name=f"prefill {name}")
        _close(tc2[name], jc2[name], name=f"decode {name}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_matches_full_forward(arch, impl):
    """The reference's test of the same name (tests/test_models.py), on the
    port: decode at position S against the full forward's last row, at
    capacity factor 8 so that no token drops."""
    tfull, tdec = _serve(arch, impl, 8.0)["full"]
    np.testing.assert_allclose(_np(tdec[:, 0]), _np(tfull[:, -1]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_step_logits_and_tokens_match_jax(arch, impl):
    jlog, tlog, jtoks, ttoks = _serve(arch, impl, 1.25)["steps"]
    assert len(jlog) == len(tlog) == STEPS + 1
    for j, t in zip(jlog, tlog):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, name="logits")
    np.testing.assert_array_equal(ttoks, jtoks)


# ------------------------------ gradients ------------------------------

@functools.lru_cache(maxsize=None)
def _grads(arch, impl, remat=False, expert_cvjp=False):
    jcfg, tcfg, jparams, tparams = _setup(arch, attn_impl=impl, remat=remat,
                                          moe_expert_cvjp=expert_cvjp)
    tokens = _tokens(jcfg, (B, S), 7)

    def jloss(p):
        h, aux = jax_forward_train(p, jcfg, {"tokens": jnp.asarray(tokens)})
        return jax_lm_loss(p, jcfg, h, jnp.asarray(tokens), aux)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tl, taux, tg = loss_and_grads(tparams, tcfg,
                                  {"tokens": torch.from_numpy(tokens)})
    for p in jax.tree.leaves(tparams):            # params left as found
        assert not p.requires_grad and p.grad is None
    return float(jl), _tree_np(jg), float(tl), tg


@pytest.mark.parametrize("arch,impl,expert_cvjp", [
    ("qwen3-moe-235b-a22b", "flash", False),
    ("qwen3-moe-235b-a22b", "flash_pallas", False),
    ("qwen3-moe-235b-a22b", "flash", True),
    ("arctic-480b", "flash_pallas", False)])
def test_loss_grads_match_jax(arch, impl, expert_cvjp):
    jl, jg, tl, tg = _grads(arch, impl, expert_cvjp=expert_cvjp)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    want, got = dict(_flat(jg)), dict(_flat(tg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _close(got[path], w, GRAD_TOL, str(path))
    for w in ("router", "w_gate", "w_up", "w_down"):
        assert float(tg["blocks"]["moe"][w].abs().sum()) > 0, w


def test_remat_matches_no_remat():
    """Checkpointed MoE layers recompute the same routing and forward:
    identical grads."""
    _, _, tl0, tg0 = _grads("qwen3-moe-235b-a22b", "flash_pallas")
    _, _, tl1, tg1 = _grads("qwen3-moe-235b-a22b", "flash_pallas",
                            remat=True)
    assert tl0 == tl1
    for (path, a), (_, b) in zip(_flat(tg0), _flat(tg1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))


# ----------------------------- train steps -----------------------------

def _assert_params_close(tp, jp, bad_frac, lr=OptConfig().lr, steps=2):
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


@functools.lru_cache(maxsize=None)
def _steps(arch, compression, n_steps=2):
    jcfg, tcfg, jparams, tparams = _setup(
        arch, attn_impl="flash_pallas", optimizer="adafactor",
        grad_compression=compression)
    jstate = jopt.opt_init("adafactor", jparams)
    tstate = opt_state_from_numpy(_tree_np(jstate), "cpu")
    jstep = jax.jit(jax_make_train_step(jcfg))
    tstep = make_train_step(tcfg, device="cpu")
    jm, tm = [], []
    for i in range(n_steps):
        tokens = _tokens(jcfg, (B, S), 10 + i)
        jparams, jstate, m = jstep(jparams, jstate,
                                   {"tokens": jnp.asarray(tokens)})
        jm.append(_tree_np(m))
        tparams, tstate, m = tstep(tparams, tstate,
                                   {"tokens": torch.from_numpy(tokens)})
        tm.append(m)
    return _tree_np(jparams), _tree_np(jstate), jm, tparams, tstate, tm


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adafactor_train_step_matches_jax(arch):
    jp, js, jm, tp, ts, tm = _steps(arch, False)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(float(t["loss"]), j["loss"], **LOSS_TOL)
        np.testing.assert_allclose(float(t["grad_norm"]), j["grad_norm"],
                                   rtol=1e-4)
        assert float(t["aux_loss"]) > 0
        np.testing.assert_allclose(float(t["aux_loss"]), j["aux_loss"],
                                   **AUX_TOL)
    _assert_params_close(tp, jp, bad_frac=1e-3)
    # the factored second moment of a 4-D expert leaf: per (layer, expert)
    for key in ("vr", "vc"):
        for path, w in _flat(js[key]):
            assert tuple(dict(_flat(ts[key]))[path].shape) == w.shape, path
    L, E, d, ff = (tp["blocks"]["moe"]["w_gate"].shape[i] for i in range(4))
    assert tuple(ts["vr"]["blocks"]["moe"]["w_gate"].shape) == (L, E, d)
    assert tuple(ts["vc"]["blocks"]["moe"]["w_gate"].shape) == (L, E, ff)
    assert int(ts["count"]) == int(js["count"]) == 2


def test_train_step_with_compression_matches_jax():
    """int8 compression on: as the dense case, at most 0.5 % of the updated
    params' elements may leave the elementwise tolerance (a value crossing
    a rounding boundary of the int8 grid)."""
    jp, js, jm, tp, ts, tm = _steps("qwen3-moe-235b-a22b", True)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(float(t["loss"]), j["loss"], **LOSS_TOL)
        np.testing.assert_allclose(float(t["grad_norm"]), j["grad_norm"],
                                   rtol=1e-4)
    _assert_params_close(tp, jp, bad_frac=5e-3)

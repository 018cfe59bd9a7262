"""The port's RG-LRU block (``repro_torch.models.rglru``) held against the
JAX package's on the CPU at smoke width: the gate coefficients, the
log-depth linear scan with and without a carried state, the block in full
and streaming mode, the decode step, and gradients.  JAX params are
converted and the inputs are numpy arrays from a seed (fp32; the scan
differs from ``lax.associative_scan`` only by reassociation)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import rglru as JR
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.models import rglru as TR

# values: 1e-5 relative plus 1e-5 of the tensor's largest |value|;
# gradients 1e-4 of the same
TOL = 1e-5
GRAD_TOL = 1e-4
B = 2


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _cfgs(**kw):
    return (dataclasses.replace(jax_smoke(JAX_ARCHS["recurrentgemma-9b"]),
                                **kw),
            dataclasses.replace(smoke_variant(ARCHS["recurrentgemma-9b"]),
                                **kw))


def _params(jcfg, seed=0):
    jp = JR.init_rglru_block(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _ab(S, w, seed):
    """Scan coefficients as the block makes them: a in (0, 1)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.999, (B, S, w)).astype(np.float32)
    return a, rng.normal(size=(B, S, w)).astype(np.float32)


def test_init_rglru_tree_matches_jax():
    """Keys, shapes and dtypes in bf16: the gate biases and lam fp32."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16")
    want = jax.eval_shape(
        lambda: JR.init_rglru_block(jax.random.PRNGKey(0), jcfg))
    got = TR.init_rglru_block(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).split(".")[1] == str(w.dtype), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_coeffs_match_jax(dtype):
    """fp32 throughout, from fp32 or bf16 params and inputs."""
    jcfg, tcfg = _cfgs(param_dtype=dtype)
    jp, tp = _params(jcfg)
    x = _x((B, 9, jcfg.lru_width), 1)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ja, jb = JR._rglru_coeffs(jp, jx)
    ta, tb = TR._rglru_coeffs(tp, tx)
    assert ta.dtype == tb.dtype == torch.float32
    _close(ta, ja, name="a")
    _close(tb, jb, name="b")
    assert float(ta.min()) > 0 and float(ta.max()) < 1


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 7, 64])
def test_linear_scan_matches_jax(S, with_h0):
    w = 16
    a, b = _ab(S, w, S)
    h0 = _x((B, w), 2) if with_h0 else None
    want = JR._linear_scan_assoc(jnp.asarray(a), jnp.asarray(b),
                                 None if h0 is None else jnp.asarray(h0))
    got = TR._linear_scan_assoc(torch.from_numpy(a), torch.from_numpy(b),
                                None if h0 is None else torch.from_numpy(h0))
    _close(got, want)
    # and the recurrence itself, step by step
    h = np.zeros((B, w), np.float32) if h0 is None else h0
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S", [1, 2, 24])
def test_rglru_block_full_matches_jax(S):
    """No carried state: y, the last state and the pre-conv tail (zero-padded
    at the front for S < K-1)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((B, S, jcfg.d_model), 3)
    jy, jh, jc = JR.rglru_block(jp, jnp.asarray(x), jcfg)
    ty, th, tc = TR.rglru_block(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy, name="y")
    _close(th, jh, name="h_final")
    assert tuple(tc.shape) == (B, jcfg.conv_width - 1, jcfg.lru_width)
    _close(tc, jc, name="conv tail")


def test_rglru_block_streaming_matches_jax():
    """From a carried state and conv tail (a prompt's continuation)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((B, 6, jcfg.d_model), 4)
    st = _x((B, jcfg.lru_width), 5)
    cv = _x((B, jcfg.conv_width - 1, jcfg.lru_width), 6)
    jy, jh, jc = JR.rglru_block(jp, jnp.asarray(x), jcfg,
                                state=jnp.asarray(st),
                                conv_state=jnp.asarray(cv))
    ty, th, tc = TR.rglru_block(tp, torch.from_numpy(x), tcfg,
                                state=torch.from_numpy(st),
                                conv_state=torch.from_numpy(cv))
    _close(ty, jy, name="y")
    _close(th, jh, name="h_final")
    _close(tc, jc, name="conv state")


def test_rglru_decode_step_matches_jax_and_the_full_block():
    """The one-token step against JAX's, and a prompt's last token decoded
    from the state of the prompt before it against the full block."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((B, 1, jcfg.d_model), 7)
    st = _x((B, jcfg.lru_width), 8)
    cv = _x((B, jcfg.conv_width - 1, jcfg.lru_width), 9)
    jy, jh, jc = JR.rglru_decode_step(jp, jnp.asarray(x), jcfg,
                                      jnp.asarray(st), jnp.asarray(cv))
    ty, th, tc = TR.rglru_decode_step(tp, torch.from_numpy(x), tcfg,
                                      torch.from_numpy(st),
                                      torch.from_numpy(cv))
    _close(ty, jy, name="y")
    _close(th, jh, name="h")
    _close(tc, jc, name="conv")

    xs = torch.from_numpy(_x((B, 12, tcfg.d_model), 10))
    y_full, h_full, _ = TR.rglru_block(tp, xs, tcfg)
    _, h, c = TR.rglru_block(tp, xs[:, :-1], tcfg)
    y_last, h_last, _ = TR.rglru_decode_step(tp, xs[:, -1:], tcfg, h, c)
    torch.testing.assert_close(y_last, y_full[:, -1:], rtol=TOL, atol=TOL)
    torch.testing.assert_close(h_last, h_full, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_grads_match_jax(with_state):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    S = 20
    x = _x((B, S, jcfg.d_model), 11)
    st = _x((B, jcfg.lru_width), 12)
    cv = _x((B, jcfg.conv_width - 1, jcfg.lru_width), 13)
    wy = _x((B, S, jcfg.d_model), 14)
    wh = _x((B, jcfg.lru_width), 15)
    kw = lambda s, c: dict(state=s, conv_state=c) if with_state else {}

    def jloss(p, xx, ss, cc):
        y, h, _ = JR.rglru_block(p, xx, jcfg, **kw(ss, cc))
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jp, jnp.asarray(x), jnp.asarray(st), jnp.asarray(cv))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(st).requires_grad_()
    y, h, _ = TR.rglru_block(tp, tx, tcfg, **kw(ts, torch.from_numpy(cv)))
    ((y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()) \
        .backward()
    for k in tp:
        assert torch.isfinite(tp[k].grad).all(), k
        _close(tp[k].grad, jg[0][k], GRAD_TOL, k)
    _close(tx.grad, jg[1], GRAD_TOL, "x")
    if with_state:
        _close(ts.grad, jg[2], GRAD_TOL, "state")

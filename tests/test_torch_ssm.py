"""The port's Mamba2 SSD layer (``repro_torch.models.ssm``) held against the
JAX package's on the CPU at smoke width: the depthwise causal conv in both
modes, ``_segsum``, ``ssd_forward`` (S a multiple of the chunk, a ragged S
that takes a shorter chunk, an initial state), ``ssd_decode_step``, the
reference's chunked-against-sequential story, and gradients.  JAX params
are converted and the inputs are numpy arrays from a seed, so both packages
compute on the same numbers (fp32; the differences are summation order
only)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import ssm as JS
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as TS

# values: 1e-5 relative plus 1e-5 of the tensor's largest |value|;
# gradients 1e-4 of the same
TOL = 1e-5
GRAD_TOL = 1e-4
# the reference's chunked vs sequential tolerance (tests/test_models.py)
SEQ_TOL = 3e-3
B = 2


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _cfgs(**kw):
    return (dataclasses.replace(jax_smoke(JAX_ARCHS["mamba2-370m"]), **kw),
            dataclasses.replace(smoke_variant(ARCHS["mamba2-370m"]), **kw))


def _params(jcfg, seed=0):
    jp = JS.init_ssm(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _din(cfg):
    return cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state


def test_init_ssm_tree_matches_jax():
    """Keys, shapes and dtypes in bf16: a_log, d_skip and dt_bias fp32."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16")
    want = jax.eval_shape(lambda: JS.init_ssm(jax.random.PRNGKey(0), jcfg))
    got = TS.init_ssm(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
    for k in ("a_log", "d_skip", "dt_bias"):
        assert got[k].dtype == torch.float32


@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv_full_and_streaming_match_jax(S):
    """The full-sequence conv, and the streaming conv from a state, whose
    new state is the last K-1 inputs (S < K-1 included)."""
    jcfg, _ = _cfgs()
    D, K = _din(jcfg), jcfg.conv_width
    x, w = _x((B, S, D), 1), _x((K, D), 2, 0.5)
    st = _x((B, K - 1, D), 3)
    _close(TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
           JS._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    ty, tst = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(st))
    jy, jst = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(st))
    _close(ty, jy)
    assert tuple(tst.shape) == (B, K - 1, D)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_streaming_conv_continues_the_full_conv():
    """Two streamed halves equal the conv over the whole sequence."""
    jcfg, _ = _cfgs()
    D, K = _din(jcfg), jcfg.conv_width
    x, w = torch.from_numpy(_x((B, 10, D), 4)), \
        torch.from_numpy(_x((K, D), 5, 0.5))
    full = TS._causal_conv(x, w)
    y1, st = TS._causal_conv(x[:, :6], w, torch.zeros((B, K - 1, D)))
    y2, _ = TS._causal_conv(x[:, 6:], w, st)
    torch.testing.assert_close(torch.cat([y1, y2], 1), full, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("Q", [1, 5, 8])
def test_segsum_matches_jax(Q):
    """Equal below and on the diagonal; -inf above it in both."""
    la = -np.abs(_x((B, 3, Q), 6))
    got = TS._segsum(torch.from_numpy(la)).numpy()
    want = np.asarray(JS._segsum(jnp.asarray(la)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == B * 3 * Q * (Q - 1) // 2
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,with_state", [(16, False), (12, False),
                                          (7, False), (16, True)])
def test_ssd_forward_matches_jax(S, with_state):
    """S = 16 is two chunks of 8; S = 12 takes Q = 6 < ssm_chunk, S = 7
    one chunk of 7; an initial state enters the inter-chunk recurrence."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    assert TS.chunk_len(S, tcfg.ssm_chunk) == {16: 8, 12: 6, 7: 7}[S]
    x = _x((B, S, jcfg.d_model), 7)
    h0 = _x((B, jcfg.ssm_heads, jcfg.ssm_state, jcfg.ssm_headdim), 8) \
        if with_state else None
    jy, jst, jtail = JS.ssd_forward(
        jp, jnp.asarray(x), jcfg,
        initial_state=None if h0 is None else jnp.asarray(h0))
    ty, tst, ttail = TS.ssd_forward(
        tp, torch.from_numpy(x), tcfg,
        initial_state=None if h0 is None else torch.from_numpy(h0))
    _close(ty, jy, name="y")
    _close(tst, jst, name="final state")
    assert tst.dtype == torch.float32
    _close(ttail, jtail, name="conv tail")


def test_ssd_forward_conv_tail_of_a_short_prompt():
    """S < K-1: the tail is zero-padded at the front, as in the reference."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((B, 2, jcfg.d_model), 9)
    _, _, jtail = JS.ssd_forward(jp, jnp.asarray(x), jcfg)
    _, _, ttail = TS.ssd_forward(tp, torch.from_numpy(x), tcfg)
    assert tuple(ttail.shape) == (B, jcfg.conv_width - 1, _din(jcfg))
    assert float(ttail[:, 0].abs().max()) == 0.0
    _close(ttail, jtail)


def test_ssd_decode_step_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((B, 1, jcfg.d_model), 10)
    st = _x((B, jcfg.ssm_heads, jcfg.ssm_state, jcfg.ssm_headdim), 11)
    cv = _x((B, jcfg.conv_width - 1, _din(jcfg)), 12)
    jy, jst, jcv = JS.ssd_decode_step(jp, jnp.asarray(x), jcfg,
                                      jnp.asarray(st), jnp.asarray(cv))
    ty, tst, tcv = TS.ssd_decode_step(tp, torch.from_numpy(x), tcfg,
                                      torch.from_numpy(st),
                                      torch.from_numpy(cv))
    _close(ty, jy, name="y")
    _close(tst, jst, name="state")
    _close(tcv, jcv, name="conv")


def test_ssd_chunked_matches_sequential():
    """The reference's story (tests/test_models.py) on the port: the
    chunked forward equals the step-by-step recurrence from zeros, and the
    final states agree; the conv tail equals the streamed conv state (the
    same inputs, projected one token at a time: 1e-5)."""
    jcfg, tcfg = _cfgs(ssm_chunk=8)
    _, tp = _params(jcfg)
    S = 32
    x = torch.from_numpy(_x((B, S, tcfg.d_model), 13))
    y_chunked, final, tail = TS.ssd_forward(tp, x, tcfg)
    state = torch.zeros((B, tcfg.ssm_heads, tcfg.ssm_state,
                         tcfg.ssm_headdim))
    conv = torch.zeros((B, tcfg.conv_width - 1, _din(tcfg)))
    ys = []
    for t in range(S):
        y_t, state, conv = TS.ssd_decode_step(tp, x[:, t:t + 1], tcfg,
                                              state, conv)
        ys.append(y_t)
    torch.testing.assert_close(y_chunked, torch.cat(ys, 1), rtol=SEQ_TOL,
                               atol=SEQ_TOL)
    torch.testing.assert_close(final, state, rtol=SEQ_TOL, atol=SEQ_TOL)
    torch.testing.assert_close(tail, conv, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_forward_grads_match_jax_and_are_finite(with_state):
    """The -inf above _segsum's diagonal is masked before exp, so the
    backward pass meets no inf * 0: every gradient is finite and equals
    jax.grad's, the initial state's included."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    S = 16
    x = _x((B, S, jcfg.d_model), 14)
    h0 = _x((B, jcfg.ssm_heads, jcfg.ssm_state, jcfg.ssm_headdim), 15)
    wy = _x((B, S, jcfg.d_model), 16)
    ws = _x(h0.shape, 17)

    def jloss(p, xx, hh):
        y, st, _ = JS.ssd_forward(p, xx, jcfg,
                                  initial_state=hh if with_state else None)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x),
                                           jnp.asarray(h0))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(h0).requires_grad_()
    y, st, _ = TS.ssd_forward(tp, tx, tcfg,
                              initial_state=th if with_state else None)
    ((y * torch.from_numpy(wy)).sum() + (st * torch.from_numpy(ws)).sum()) \
        .backward()
    for k in tp:
        assert torch.isfinite(tp[k].grad).all(), k
        _close(tp[k].grad, jg[0][k], GRAD_TOL, k)
    _close(tx.grad, jg[1], GRAD_TOL, "x")
    if with_state:
        _close(th.grad, jg[2], GRAD_TOL, "initial state")
    else:
        assert th.grad is None

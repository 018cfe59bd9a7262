"""The port's model layers (``repro_torch.models.layers``) held against the
JAX package's (``repro.models.layers``) on the same numpy inputs, in fp32
at 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import layers as JL
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), **kw),
            dataclasses.replace(smoke_variant(ARCHS[arch]), **kw))


def _attn_params(cfg, rng):
    d, D = cfg.d_model, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    return {"wq": rng.normal(0, s, (d, cfg.n_heads * D)).astype(np.float32),
            "wk": rng.normal(0, s, (d, cfg.kv_dim)).astype(np.float32),
            "wv": rng.normal(0, s, (d, cfg.kv_dim)).astype(np.float32),
            "wo": rng.normal(0, s, (cfg.n_heads * D, d)).astype(np.float32)}


@pytest.mark.parametrize("norm_bf16", [False, True])
def test_rms_norm(norm_bf16):
    rng = _rng(1)
    x = rng.normal(0, 1.5, (2, 8, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, (64,)).astype(np.float32)
    JL.set_norm_bf16(norm_bf16)
    TL.set_norm_bf16(norm_bf16)
    try:
        want = JL.rms_norm(jnp.asarray(x), jnp.asarray(w))
        got = TL.rms_norm(_t(x), _t(w))
    finally:
        JL.set_norm_bf16(False)
        TL.set_norm_bf16(False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pct", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("norm_bf16", [False, True])
def test_apply_rope(pct, norm_bf16):
    rng = _rng(2)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 15, dtype=np.int32), (2, 12))
    np.testing.assert_array_equal(TL.rope_freqs(16, pct, 10000.0),
                                  np.asarray(JL.rope_freqs(16, pct, 10000.0)))
    JL.set_norm_bf16(norm_bf16)
    TL.set_norm_bf16(norm_bf16)
    try:
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), pct, 10000.0)
        got = TL.apply_rope(_t(x), _t(pos), pct, 10000.0)
    finally:
        JL.set_norm_bf16(False)
        TL.set_norm_bf16(False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,prefix", [(0, 0), (5, 0), (0, 4), (6, 3)])
def test_causal_mask(window, prefix):
    want = np.asarray(JL.causal_mask(16, window=window, prefix=prefix))
    got = TL.causal_mask(16, window=window, prefix=prefix).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_kv", [1, 2, 4])
def test_gqa_scores_softmax_v(masked, n_kv):
    rng = _rng(3 + n_kv)
    q = rng.normal(size=(2, 10, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 10, n_kv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 10, n_kv, 16)).astype(np.float32)
    jm = JL.causal_mask(10, window=4) if masked else None
    tm = TL.causal_mask(10, window=4) if masked else None
    want = JL.gqa_scores_softmax_v(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jm, n_kv)
    got = TL.gqa_scores_softmax_v(_t(q), _t(k), _t(v), tm, n_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["deepseek-7b", "chatglm3-6b"])
@pytest.mark.parametrize("pos", [3, 11, 12, 29])
def test_attention_decode_ring(arch, pos):
    """pos < S_cache writes slot pos and masks the unwritten slots;
    pos >= S_cache wraps the ring (slot pos % S_cache) and sees every
    slot."""
    jcfg, tcfg = _cfgs(arch)
    rng = _rng(pos)
    S_cache = 12
    p = _attn_params(jcfg, rng)
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(2, S_cache, jcfg.n_kv_heads, 16)).astype(np.float32)
    cv = rng.normal(size=(2, S_cache, jcfg.n_kv_heads, 16)).astype(np.float32)
    want, wk, wv = JL.attention_decode(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jcfg,
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos, jnp.int32),
        jcfg.n_heads)
    tk, tv = _t(ck.copy()), _t(cv.copy())
    got, gk, gv = TL.attention_decode(params_from_numpy(p, "cpu"), _t(x),
                                      tcfg, tk, tv, pos, tcfg.n_heads)
    assert gk is tk and gv is tv          # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(mlp):
    jcfg, tcfg = _cfgs("deepseek-7b", mlp=mlp)
    rng = _rng(5)
    d, ff = jcfg.d_model, jcfg.d_ff
    names = (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d))) \
        if mlp != "gelu" else (("w_in", (d, ff)), ("w_out", (ff, d)))
    p = {n: rng.normal(0, 1 / np.sqrt(s[0]), s).astype(np.float32)
         for n, s in names}
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    want = JL.apply_mlp({n: jnp.asarray(a) for n, a in p.items()},
                        jnp.asarray(x), jcfg)
    got = TL.apply_mlp(params_from_numpy(p, "cpu"), _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_and_lm_logits():
    rng = _rng(6)
    V, d = 256, 64
    p = {"tok": rng.normal(0, 0.02, (V, d)).astype(np.float32),
         "head": rng.normal(0, 1 / 8, (d, V)).astype(np.float32),
         "final_norm": rng.normal(1, 0.1, (d,)).astype(np.float32)}
    tokens = rng.integers(0, V, (2, 7)).astype(np.int32)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = params_from_numpy(p, "cpu")
    np.testing.assert_array_equal(TL.embed(tp, _t(tokens)).numpy(),
                                  np.asarray(JL.embed(jp, jnp.asarray(tokens))))
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    np.testing.assert_allclose(TL.lm_logits(tp, _t(x)).numpy(),
                               np.asarray(JL.lm_logits(jp, jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("arch", ["deepseek-7b", "chatglm3-6b"])
def test_init_shapes_and_scales_match(arch):
    """Same keys, shapes, dtypes and init scales as the JAX init (the draws
    themselves differ: torch and JAX generators)."""
    import jax
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    pairs = [(JL.init_attention(key, jcfg), TL.init_attention(gen, tcfg)),
             (JL.init_mlp(key, jcfg), TL.init_mlp(gen, tcfg)),
             (JL.init_embedding(key, jcfg), TL.init_embedding(gen, tcfg))]
    for jp, tp in pairs:
        assert sorted(jp) == sorted(tp)
        for n in jp:
            assert tuple(jp[n].shape) == tuple(tp[n].shape), n
            assert tp[n].dtype == torch.bfloat16, n
            js = float(np.std(np.asarray(jp[n], np.float32)))
            ts = float(tp[n].float().std())
            assert abs(js - ts) <= 0.1 * js + 1e-6, (n, js, ts)

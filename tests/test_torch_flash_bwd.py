"""The port's flash-attention backward held against the JAX package on the
CPU, where the port's wrappers take their plain twins: ``flash_bwd`` against
``flash_bwd_pallas`` (interpret mode), and the gradients of
``ops.flash_attention`` (kernel path) and of the ``flash_cvjp``
``flash_attention`` against ``jax.grad`` of their JAX counterparts.  Cases
and the 4e-3 gradient tolerance are those of tests/test_flash_kernels.py."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_bwd_pallas, flash_fwd_pallas
from repro.kernels.ops import pallas_flash_attention
from repro.models.attention_flash import blockwise_attention as jax_blockwise
from repro.models.attention_flash_vjp import flash_attention as jax_cvjp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.attention_flash_vjp import \
    flash_attention as cvjp_attention

CASES = [
    # B, S, Hq, n_kv, D, causal, window, prefix
    (2, 64, 4, 2, 128, True, 0, 0),     # GQA causal
    (2, 64, 4, 2, 80, True, 0, 0),      # head dim not a multiple of 128
    (2, 96, 4, 1, 128, True, 32, 0),    # MQA + sliding window
    (2, 64, 4, 4, 128, True, 0, 16),    # prefix-LM
    (1, 64, 4, 4, 128, False, 0, 0),    # bidirectional (encoder)
]
GRAD_TOL = dict(rtol=4e-3, atol=4e-3)


def _mk(case, seed=11):
    B, S, Hq, n_kv, D = case[:5]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, n_kv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, n_kv, D)).astype(np.float32)
    do = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    return q, k, v, do


def _five_d(x, n_kv):
    B, S, H, D = x.shape
    return np.ascontiguousarray(
        x.reshape(B, S, n_kv, H // n_kv, D).transpose(0, 2, 3, 1, 4))


@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_matches_pallas_kernel(case):
    B, S, Hq, n_kv, D, causal, window, prefix = case
    q, k, v, do = _mk(case)
    q5, do5 = _five_d(q, n_kv), _five_d(do, n_kv)
    k4 = np.ascontiguousarray(k.transpose(0, 2, 1, 3))
    v4 = np.ascontiguousarray(v.transpose(0, 2, 1, 3))
    mask = dict(causal=causal, window=window, prefix=prefix)
    out, lse = flash_fwd_pallas(jnp.asarray(q5), jnp.asarray(k4),
                                jnp.asarray(v4), bq=16, bk=32,
                                interpret=True, **mask)
    lse = np.asarray(lse)
    delta = (do5 * np.asarray(out)).sum(-1).astype(np.float32)
    want = flash_bwd_pallas(jnp.asarray(q5), jnp.asarray(k4),
                            jnp.asarray(v4), jnp.asarray(do5),
                            jnp.asarray(lse), jnp.asarray(delta), bq=16,
                            bk=32, interpret=True, **mask)
    counts = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    got = fa.flash_bwd(*(torch.from_numpy(a) for a in
                         (q5, k4, v4, do5, lse, delta)), **mask)
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == counts  # twin
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


# bf16 limits of chip_smoke.py for the backward kernels against their twin:
# elementwise 1e-2 relative plus 1e-2 of the largest |value|, and 1e-2 for
# each of 8 row blocks' relative norm error.
BF16_GRAD_TOL = 1e-2
BF16_BLOCK_REL_TOL = 1e-2


def _bf16(x):
    return torch.tensor(np.asarray(x)).to(torch.bfloat16).float()


def _bwd_tensor_core_roundings(q, k, v, do, lse, delta, causal, window,
                               prefix, chunks=1):
    """The bf16 backward kernels' arithmetic (csrc/flash_bwd.cu, *_tc and
    *_wg): s and dP as fp32 sums of exact products of bf16 inputs, p and ds
    in fp32, p and ds rounded to bf16 before p.dO, ds.k and ds.q, fp32 sums,
    and dq, dk, dv rounded to bf16 once.  ``chunks``: the wgmma dk/dv pass's
    group split, each chunk of the G groups ([c G / n, (c + 1) G / n)) summed
    into fp32 partials, the partials summed in chunk order, then rounded."""
    S, Sk, D, G = q.shape[3], k.shape[2], q.shape[4], q.shape[2]
    scale = 1.0 / np.sqrt(D)
    allow = fa._allow(S, Sk, causal, window, prefix, "cpu")
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k) * scale
    p = torch.exp(s.masked_fill(~allow, fa.NEG) - lse[..., None])
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    p, ds = _bf16(p), _bf16(ds)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k)
    dk = dv = 0.0
    bounds = [c * G // chunks for c in range(chunks + 1)]
    for lo, hi in zip(bounds, bounds[1:]):
        dk = dk + torch.einsum("bhgqk,bhgqd->bhkd", ds[:, :, lo:hi],
                               q[:, :, lo:hi])
        dv = dv + torch.einsum("bhgqk,bhgqd->bhkd", p[:, :, lo:hi],
                               do[:, :, lo:hi])
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _assert_bf16_limits(got, want):
    """chip_smoke.py's bf16 limits: elementwise, and in 8 row blocks."""
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        w = torch.tensor(np.asarray(w))
        assert g.shape == w.shape
        torch.testing.assert_close(
            g, w, rtol=BF16_GRAD_TOL,
            atol=BF16_GRAD_TOL * float(w.abs().max()), msg=name)
        for i, (gb, wb) in enumerate(zip(torch.tensor_split(g, 8, -2),
                                         torch.tensor_split(w, 8, -2))):
            rel = float((gb - wb).norm() / wb.norm())
            assert rel <= BF16_BLOCK_REL_TOL, (name, i, rel)


def _bf16_case_vs_pallas(case, chunks=1):
    """A case's bf16-rounded inputs through the JAX ``flash_bwd_pallas``
    (interpret mode, fp32) and the emulation of the bf16 kernels."""
    B, S, Hq, n_kv, D, causal, window, prefix = case
    q, k, v, do = (_bf16(a).numpy() for a in _mk(case, seed=S + 3 * D))
    q5, do5 = _five_d(q, n_kv), _five_d(do, n_kv)
    k4 = np.ascontiguousarray(k.transpose(0, 2, 1, 3))
    v4 = np.ascontiguousarray(v.transpose(0, 2, 1, 3))
    mask = dict(causal=causal, window=window, prefix=prefix)
    out, lse = flash_fwd_pallas(jnp.asarray(q5), jnp.asarray(k4),
                                jnp.asarray(v4), bq=16, bk=16,
                                interpret=True, **mask)
    lse = np.asarray(lse)
    delta = (do5 * _bf16(np.asarray(out)).numpy()).sum(-1) \
        .astype(np.float32)
    want = flash_bwd_pallas(jnp.asarray(q5), jnp.asarray(k4),
                            jnp.asarray(v4), jnp.asarray(do5),
                            jnp.asarray(lse), jnp.asarray(delta), bq=16,
                            bk=16, interpret=True, **mask)
    got = _bwd_tensor_core_roundings(
        *(torch.from_numpy(a) for a in (q5, k4, v4, do5, lse, delta)),
        **mask, chunks=chunks)
    return got, want


@pytest.mark.parametrize("case", CASES + [
    (1, 80, 4, 2, 128, True, 0, 0),     # S not a multiple of 64-row tiles
    (2, 64, 4, 2, 40, True, 0, 0),      # D zero-padded to 48 in the kernel
])
def test_bf16_tensor_core_roundings_match_pallas_kernel(case):
    """The rounding points of the bf16 tensor-core kernels, emulated on the
    CPU, against the JAX ``flash_bwd_pallas`` (interpret mode, fp32) on the
    same bf16-rounded inputs, under chip_smoke.py's bf16 limits."""
    _assert_bf16_limits(*_bf16_case_vs_pallas(case))


@pytest.mark.parametrize("case,chunks", [
    ((2, 64, 4, 4, 64, True, 0, 0), 1),        # G = 1: no split
    ((2, 64, 4, 2, 128, True, 0, 16), 2),      # G = 2, one group a chunk
    ((1, 80, 8, 1, 256, True, 0, 16), 3),      # G = 8, 3 chunks of 2-3
    ((1, 64, 16, 1, 128, True, 0, 0), 3),      # G = 16, 3 chunks of 5-6
    ((1, 96, 16, 1, 64, True, 32, 0), 5),      # G = 16, window, 5 chunks
    ((1, 64, 16, 1, 256, False, 0, 0), 16),    # G = 16, one group a chunk
])
def test_bf16_group_split_roundings_match_pallas_kernel(case, chunks):
    """The wgmma dk/dv pass's group split, emulated: fp32 partials a chunk
    of groups, summed in chunk order and rounded to bf16 once, against the
    JAX kernel under the same limits (chunk counts that divide G and that
    do not)."""
    _assert_bf16_limits(*_bf16_case_vs_pallas(case, chunks))


def _grads_torch(fn, q, k, v, do):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out, [t.grad.numpy() for t in ts]


def _grads_jax(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return out, [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("impl", ["flash_pallas", "flash_cvjp"])
@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax(case, impl):
    B, S, Hq, n_kv, D, causal, window, prefix = case
    q, k, v, do = _mk(case, seed=S + D)
    if impl == "flash_pallas":
        tfn = lambda *a: flash_attention(*a, n_kv, causal, window, prefix,
                                         16, 32)
        jfn = lambda *a: pallas_flash_attention(*a, n_kv, causal, window,
                                                prefix, 16, 32)
    else:
        tfn = lambda *a: cvjp_attention(*a, n_kv, causal, window, prefix,
                                        16, 32)
        jfn = lambda *a: jax_cvjp(*a, n_kv, causal, window, prefix, 16, 32)
    tout, tg = _grads_torch(tfn, q, k, v, do)
    jout, jg = _grads_jax(jfn, q, k, v, do)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=3e-4, atol=3e-4)
    for a, b, name in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("S", [40, 100])
def test_kernel_path_grads_ragged_seq_match_blockwise(S):
    """A ragged S, which the TPU kernel refuses and the Hopper kernels mask:
    the plain twins' gradients against jax.grad of the blockwise oracle."""
    case = (2, S, 4, 2, 64, True, 0, 0)
    q, k, v, do = _mk(case, seed=S)
    _, tg = _grads_torch(lambda *a: flash_attention(*a, 2, True), q, k, v,
                         do)
    _, jg = _grads_jax(lambda *a: jax_blockwise(*a, 2, causal=True, bq=16,
                                                bk=32), q, k, v, do)
    for a, b, name in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_cvjp_bf16_roundings_match_jax():
    """bf16 inputs: p rounded to bf16 before dv, ds before dq/dk, fp32
    accumulators, on both sides; the two frameworks round bf16 products at
    slightly different places, so grads agree to a few bf16 ulps of their
    scale: relative norm error <= 2e-2."""
    case = (2, 64, 4, 2, 64, True, 0, 0)
    q, k, v, do = (a.astype(ml_dtypes.bfloat16) for a in _mk(case, seed=5))
    ts = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
          .requires_grad_() for a in (q, k, v)]
    out = cvjp_attention(*ts, 2, True, 0, 0, 16, 32)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(do.view(np.int16)).view(torch.bfloat16))
    _, jg = _grads_jax(lambda *a: jax_cvjp(*a, 2, True, 0, 0, 16, 32),
                       q, k, v, do)
    for t, b, name in zip(ts, jg, "qkv"):
        assert t.grad.dtype == torch.bfloat16
        a = t.grad.float().numpy()
        b = b.astype(np.float32)
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= 2e-2, (name, rel)


def test_kernel_path_output_carries_the_autograd_function():
    """The kernel path is one autograd Function, forward and backward kernels
    alike: its output's grad_fn is that Function's node, and a backward pass
    gives q, k and v nonzero gradients.  (A kernel that fills a tensor
    through ctypes outside such a Function leaves no history, and wq/wk/wv
    silently get no gradient through attention.)"""
    q, k, v, do = _mk(CASES[0])
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, 2, True)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    for t in ts:
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)


@pytest.mark.parametrize("bad", ["do_shape", "do_dtype", "lse", "delta",
                                 "device"])
def test_flash_bwd_rejects_what_the_kernels_do_not_take(bad):
    q = torch.zeros(1, 2, 1, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    do = torch.zeros(1, 2, 1, 8, 16)
    lse = torch.zeros(1, 2, 1, 8)
    delta = torch.zeros(1, 2, 1, 8)
    if bad == "do_shape":
        do = do[..., :4, :]
    elif bad == "do_dtype":
        do = do.double()
    elif bad == "lse":
        lse = lse[..., :4]
    elif bad == "delta":
        delta = delta.to(torch.bfloat16)
    else:
        q, k, do, lse, delta = (x.to("meta") for x in (q, k, do, lse, delta))
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, k, do, lse, delta)

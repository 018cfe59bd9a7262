"""The port's flash attention (``repro_torch.kernels``, blockwise torch) held
against the JAX package's Pallas kernel (interpret mode) and blockwise
oracle, forward only, on the CPU where the port's wrapper takes the plain
version.  Cases and tolerances are those of tests/test_flash_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_fwd_pallas
from repro.kernels.ops import pallas_flash_attention
from repro.models.attention_flash import blockwise_attention as jax_blockwise
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.attention_flash import blockwise_attention

CASES = [
    # B, S, Hq, n_kv, D, causal, window, prefix
    (2, 64, 4, 2, 128, True, 0, 0),     # GQA causal
    (2, 64, 4, 2, 80, True, 0, 0),      # head dim not a multiple of 128
    (2, 96, 4, 1, 128, True, 32, 0),    # MQA + sliding window
    (2, 64, 4, 4, 128, True, 0, 16),    # prefix-LM
    (1, 64, 4, 4, 128, False, 0, 0),    # bidirectional (encoder)
]
TOL = dict(rtol=3e-4, atol=3e-4)


def _mk(case, seed=11):
    B, S, Hq, n_kv, D = case[:5]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, n_kv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, n_kv, D)).astype(np.float32)
    return q, k, v


def _five_d(q, k, v, n_kv):
    B, S, Hq, D = q.shape
    q5 = q.reshape(B, S, n_kv, Hq // n_kv, D).transpose(0, 2, 3, 1, 4)
    return (np.ascontiguousarray(q5), np.ascontiguousarray(k.transpose(0, 2, 1, 3)),
            np.ascontiguousarray(v.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("case", CASES)
def test_flash_fwd_matches_pallas_kernel(case):
    B, S, Hq, n_kv, D, causal, window, prefix = case
    q5, k4, v4 = _five_d(*_mk(case), n_kv)
    want_out, want_lse = flash_fwd_pallas(
        jnp.asarray(q5), jnp.asarray(k4), jnp.asarray(v4), causal=causal,
        window=window, prefix=prefix, bq=16, bk=32, interpret=True)
    before = fa.LAUNCHES
    out, lse = fa.flash_fwd(torch.from_numpy(q5), torch.from_numpy(k4),
                            torch.from_numpy(v4), causal=causal,
                            window=window, prefix=prefix)
    assert fa.LAUNCHES == before      # CPU tensors: plain version, no launch
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_ops_flash_attention_matches_pallas_wrapper(case):
    B, S, Hq, n_kv, D, causal, window, prefix = case
    q, k, v = _mk(case)
    want = pallas_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), n_kv, causal, window,
                                  prefix, 16, 32)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), n_kv, causal, window, prefix,
                          16, 32)
    assert got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_blockwise_matches_jax_blockwise(case):
    B, S, Hq, n_kv, D, causal, window, prefix = case
    q, k, v = _mk(case)
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         n_kv, causal=causal, window=window, prefix=prefix,
                         bq=16, bk=32)
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), n_kv, causal=causal,
                              window=window, prefix=prefix, bq=16, bk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [40, 100])
def test_flash_fwd_ragged_seq_matches_blockwise(S):
    """A ragged S (no block multiple), which the TPU kernel refuses and the
    Hopper kernel masks: the plain version against JAX's blockwise oracle
    (single-block fallback)."""
    case = (2, S, 4, 2, 64, True, 0, 0)
    q, k, v = _mk(case, seed=S)
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                         causal=True, bq=16, bk=32)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), 2, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_fwd_bf16_plain_version_matches_fp32():
    """bf16 inputs: fp32 arithmetic inside, one rounding of `out`."""
    case = CASES[0]
    q5, k4, v4 = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _five_d(*_mk(case), case[3]))
    out, lse = fa.flash_fwd(q5, k4, v4)
    ref_out, ref_lse = fa.flash_fwd(q5.float(), k4.float(), v4.float())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), ref_out.numpy(),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), **TOL)


@pytest.mark.parametrize("bad", ["rank", "shape", "dtype", "half",
                                 "head_dim", "device"])
def test_flash_fwd_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 2, 1, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 16)
    if bad == "rank":
        q = q[0]
    elif bad == "shape":
        k = torch.zeros(1, 3, 8, 16)
    elif bad == "dtype":
        k = k.double()
    elif bad == "half":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = (torch.zeros(*x.shape[:-1], 300) for x in (q, k, v))
    else:
        q, k, v = (x.to("meta") for x in (q, k, v))
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v)

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


# bf16 limits of chip_smoke.py for the forward kernel against its twin:
# out 1e-2, lse 1e-3, and 1e-2 for each of 8 row blocks' relative norm
# error.
BF16_TOL = dict(out=1e-2, lse=1e-3, block=1e-2)


def _bf16(x):
    return torch.as_tensor(np.asarray(x)).to(torch.bfloat16).float()


def _fwd_tensor_core_roundings(q, k, v, causal, window, prefix, scale,
                               bk=64):
    """The bf16 forward kernel's arithmetic (csrc/flash_fwd.cu,
    flash_fwd_tc_kernel): s as fp32 sums of exact products of bf16 inputs
    (a negative scale as (-q).k.|scale|), the online softmax over kv tiles
    of ``bk`` columns in fp32, p rounded to bf16 as the operand of P.V, l
    summed from the fp32 p, fp32 sums, and ``out`` rounded to bf16 once."""
    S, Sk = q.shape[3], k.shape[2]
    allow = fa._allow(S, Sk, causal, window, prefix, "cpu")
    sign = -1.0 if scale < 0 else 1.0
    s = torch.einsum("bhgqd,bhkd->bhgqk", sign * q, k) * abs(scale)
    s = s.masked_fill(~allow, fa.NEG)
    m = torch.full(s.shape[:-1], fa.NEG)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, Sk, bk):
        st = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", _bf16(p), v[:, :, k0:k0 + bk])
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return _bf16(acc / l[..., None]), m + torch.log(l)


@pytest.mark.parametrize("case", CASES + [
    (1, 80, 4, 2, 128, True, 0, 0),     # S not a multiple of 64-row tiles
    (1, 144, 4, 1, 128, True, 48, 0),   # ragged S with a window
    (2, 64, 4, 2, 40, True, 0, 0),      # D zero-padded to 48 in the kernel
    # a negative scale, -1/sqrt(D): causal, and windowed
    (2, 64, 4, 2, 128, True, 0, 0, -1),
    (1, 144, 4, 1, 128, True, 48, 0, -1),
])
def test_bf16_tensor_core_roundings_match_pallas_kernel(case):
    """The rounding points of the bf16 tensor-core forward kernel, emulated
    on the CPU, against the JAX ``flash_fwd_pallas`` (interpret mode, fp32)
    on the same bf16-rounded inputs, under chip_smoke.py's bf16 limits."""
    B, S, Hq, n_kv, D, causal, window, prefix = case[:8]
    scale = (case[8] if len(case) > 8 else 1) / np.sqrt(D)
    q5, k4, v4 = (_bf16(a).numpy()
                  for a in _five_d(*_mk(case, seed=S + 3 * D), n_kv))
    mask = dict(causal=causal, window=window, prefix=prefix)
    want_out, want_lse = flash_fwd_pallas(
        jnp.asarray(q5), jnp.asarray(k4), jnp.asarray(v4), bq=16, bk=16,
        scale=scale, interpret=True, **mask)
    out, lse = _fwd_tensor_core_roundings(
        *(torch.from_numpy(a) for a in (q5, k4, v4)), scale=scale, **mask)
    want_out = torch.tensor(np.asarray(want_out))
    want_lse = torch.tensor(np.asarray(want_lse))
    torch.testing.assert_close(out, want_out, rtol=BF16_TOL["out"],
                               atol=BF16_TOL["out"])
    torch.testing.assert_close(lse, want_lse, rtol=BF16_TOL["lse"],
                               atol=BF16_TOL["lse"])
    for i, (gb, wb) in enumerate(zip(torch.tensor_split(out, 8, -2),
                                     torch.tensor_split(want_out, 8, -2))):
        rel = float((gb - wb).norm() / wb.norm())
        assert rel <= BF16_TOL["block"], (i, rel)


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

"""The port's int8 quantizer held against the JAX package, bit for bit, on
the CPU where the port's wrappers take their plain twins: the twins against
``quantize_pallas``/``dequantize_pallas`` in interpret mode (ties at .5, a
zero group, bf16 input), the ``ops`` round trip with ``meta``, and
``compress_grads`` on identical grad trees."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.quantize import (GROUP, dequantize_pallas,
                                    quantize_pallas)
from repro.train.train_step import compress_grads as jax_compress
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz
from repro_torch.train import compress_grads


def _groups(seed, n_groups=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (n_groups, GROUP)).astype(np.float32)
    x[3] = 0.0                                   # an all-zero group
    # exact .5 ties after the divide: absmax 127 gives scale 1.0, so
    # x / scale lands on k + 0.5 and must round half to even
    x[5] = rng.integers(-126, 126, GROUP) + 0.5
    x[5, 0] = 127.0
    x[6] = rng.normal(0, 1e-30, GROUP)           # tiny values
    return x


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_twin_bit_exact_with_pallas(seed):
    x = _groups(seed)
    qj, sj = quantize_pallas(jnp.asarray(x), interpret=True)
    before = qz.QUANT_LAUNCHES
    q, s = qz.quantize(torch.from_numpy(x))
    assert qz.QUANT_LAUNCHES == before        # CPU: twin, no launch
    assert q.dtype == torch.int8 and tuple(s.shape) == (x.shape[0], 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert s[3, 0] == 1.0 and not q[3].any()
    ties = x[5, 1:]
    want = np.clip(np.round(ties), -127, 127)    # numpy rounds half to even
    np.testing.assert_array_equal(q.numpy()[5, 1:], want.astype(np.int8))


def test_dequantize_twin_bit_exact_with_pallas():
    x = _groups(2)
    qj, sj = quantize_pallas(jnp.asarray(x), interpret=True)
    want = np.asarray(dequantize_pallas(qj, sj, interpret=True))
    q = torch.from_numpy(np.asarray(qj))
    s = torch.from_numpy(np.asarray(sj))
    before = qz.DEQUANT_LAUNCHES
    got = qz.dequantize(q, s)
    assert qz.DEQUANT_LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want)
    # bf16 output: the fp32 product rounded once, as astype(bfloat16)
    got16 = qz.dequantize(q, s, torch.bfloat16)
    np.testing.assert_array_equal(
        _bits(got16), want.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_quantize_reads_bf16_as_its_fp32_widening():
    x = _groups(3).astype(ml_dtypes.bfloat16)
    qj, sj = quantize_pallas(jnp.asarray(x.astype(np.float32)),
                             interpret=True)
    t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    q, s = qz.quantize(t)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("bad", ["shape", "dtype", "scales", "device"])
def test_quantize_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(8, GROUP)
    q = torch.zeros(8, GROUP, dtype=torch.int8)
    s = torch.ones(8, 1)
    with pytest.raises(ValueError):
        if bad == "shape":
            qz.quantize(torch.zeros(8, 512))
        elif bad == "dtype":
            qz.quantize(x.double())
        elif bad == "scales":
            qz.dequantize(q, torch.ones(8))
        else:
            qz.quantize(x.to("meta"))


@pytest.mark.parametrize("shape", [(5,), (37, 513), (3, 7, 11),
                                   (1, GROUP * 8)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_ops_round_trip_matches_jax(shape, dtype):
    x = np.random.default_rng(sum(shape)).normal(0, 3, shape).astype(dtype)
    qj, sj, _ = jops.quantize(x)
    q, s, meta = ops.quantize(torch.from_numpy(x))
    assert meta == (shape, torch.from_numpy(x).dtype, x.size)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    back = ops.dequantize(q, s, meta)
    assert tuple(back.shape) == shape and back.dtype == meta[1]
    want = jops.dequantize(qj, sj, (shape, x.dtype, x.size))
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


def test_compress_grads_bit_exact_with_jax():
    """Leaves of 8191 (passes through untouched) and 8192 elements, a
    padded one, fp32 and bf16, a nested tree."""
    rng = np.random.default_rng(7)
    tree = {
        "small": rng.normal(0, 1, (8191,)).astype(np.float32),
        "exact": rng.normal(0, 1, (8, GROUP)).astype(np.float32),
        "padded": rng.normal(0, 1, (3, 5000)).astype(np.float32),
        "blocks": {"w": rng.normal(0, 0.01, (2, 64, 200))
                   .astype(ml_dtypes.bfloat16),
                   "norm": rng.normal(0, 1, (2, 64))
                   .astype(ml_dtypes.bfloat16)},
    }
    want = jax.tree.map(np.asarray, jax_compress(
        jax.tree.map(jnp.asarray, tree), interpret=True))
    t = params_from_numpy(tree, "cpu")
    small = t["small"]
    got = compress_grads(t)
    assert got["small"] is small                 # under 8192: untouched
    for path in (("small",), ("exact",), ("padded",), ("blocks", "w"),
                 ("blocks", "norm")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert tuple(g.shape) == w.shape
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(g), w.view(np.uint16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    # 11 of deepseek's 12 leaves compress at full width; here 3 of 5 do,
    # and the round trip did change them
    assert not np.array_equal(got["exact"].numpy(), tree["exact"])

"""Group-wise int8 quantize / dequantize: the Hopper kernels' wrappers and
their plain twins.

``quantize`` and ``dequantize`` are the counterparts of the JAX package's
``quantize_pallas`` and ``dequantize_pallas`` (kernels/quantize.py) with
their signatures: groups of ``GROUP`` values, ``scale = absmax / 127``
(1.0 for an all-zero group, and computed as ``absmax * fp32(1/127)``, as
XLA computes the reference), ``q = clip(round_half_even(x / scale), ±127)``
in int8.  On a CUDA tensor each launches its kernel in ``csrc/quantize.cu``
or raises; on a CPU tensor each computes its plain twin
(``quantize_reference``, ``dequantize_reference``), which ``chip_smoke.py``
also uses as the on-card oracle.  ``QUANT_LAUNCHES`` and
``DEQUANT_LAUNCHES`` count kernel launches and nothing else.

Unlike the TPU kernel, ``quantize`` also takes bf16 groups (the gradient's
own dtype): widening bf16 to fp32 is exact, so the result is the same as
for ``groups.float()`` and the caller needs no fp32 copy.  ``dequantize``
may likewise write bf16: its fp32 product rounded once, the same number as
the fp32 output cast afterwards.

``quantize_op`` and ``dequantize_op`` are the same entry points registered
as PyTorch custom ops (``repro_torch::quantize``, ``::dequantize``), which
``ops.quantize`` / ``ops.dequantize`` call: on a CUDA or CPU tensor the op
runs the wrapper; on a meta tensor only its fake runs, making outputs of
the kernel's shapes and dtypes.  They do no products, so a FLOP counter
charges them nothing; a byte counter sees their operands and results.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .build import DTYPE_CODES

GROUP = 1024
BLOCK_GROUPS = 8
# each library function's arguments before the stream (``build.kernel``)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int)

QUANT_LAUNCHES = 0
DEQUANT_LAUNCHES = 0


_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_reference(groups):
    """Plain torch with the TPU kernel's arithmetic, in fp32.  The scale is
    ``absmax * fp32(1/127)``: XLA turns the reference's ``absmax / 127.0``
    into that product, which differs from a true divide by one ulp in some
    groups; ``x / scale`` stays a true divide."""
    x = groups.float()
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * _INV_127,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_reference(q, scales, out_dtype=torch.float32):
    return (q.float() * scales).to(out_dtype)


def _check_groups(t, name):
    if t.dim() != 2 or t.shape[1] != GROUP or t.shape[0] < 1:
        raise ValueError(f"{name} must be (n_groups, {GROUP}), got "
                         f"{tuple(t.shape)}")


def _cuda_ready(*ts):
    """True for CUDA tensors the kernel takes, False for CPU tensors;
    raises for anything else."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("tensors lie on different devices")
    if not build.on_card(dev):
        return False
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel needs contiguous, 16-byte aligned "
                             "tensors")
    return True


def quantize(groups):
    """groups: (n_groups, 1024) fp32 or bf16.  Returns (q int8 of the same
    shape, scales (n_groups, 1) fp32)."""
    _check_groups(groups, "groups")
    if groups.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {groups.dtype}")
    if not _cuda_ready(groups):
        return quantize_reference(groups)
    n = groups.shape[0]
    q = torch.empty(groups.shape, dtype=torch.int8, device=groups.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=groups.device)
    build.launch(build.kernel("quantize", "quantize", _ARGTYPES),
                 groups.device, groups.data_ptr(), q.data_ptr(),
                 scales.data_ptr(), n, DTYPE_CODES[groups.dtype],
                 what="quantize")
    global QUANT_LAUNCHES
    QUANT_LAUNCHES += 1
    return q, scales


def dequantize(q, scales, out_dtype=torch.float32):
    """q: (n_groups, 1024) int8; scales: (n_groups, 1) fp32.  Returns
    ``q * scales`` in ``out_dtype`` (fp32 by default, as the TPU kernel;
    bf16 rounds that product once)."""
    _check_groups(q, "q")
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or tuple(scales.shape) != (q.shape[0], 1):
        raise ValueError(f"dequantize takes int8 q and fp32 (n_groups, 1) "
                         f"scales, got {q.dtype} {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if not _cuda_ready(q, scales):
        return dequantize_reference(q, scales, out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    build.launch(build.kernel("quantize", "dequantize", _ARGTYPES),
                 q.device, q.data_ptr(), scales.data_ptr(), out.data_ptr(),
                 q.shape[0], DTYPE_CODES[out_dtype], what="dequantize")
    global DEQUANT_LAUNCHES
    DEQUANT_LAUNCHES += 1
    return out


# ----------------------------- custom ops -----------------------------

# Registered as flash_attention.py registers its ops (see there): the
# wrappers for the CPU and CUDA keys, a fake for everything else.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("quantize(Tensor groups) -> (Tensor, Tensor)")
_LIB.define("dequantize(Tensor q, Tensor scales, ScalarType out_dtype) "
            "-> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("quantize", quantize, _key)
    _LIB.impl("dequantize", dequantize, _key)


@torch.library.register_fake("repro_torch::quantize", lib=_LIB)
def _quantize_fake(groups):
    _check_groups(groups, "groups")
    return (groups.new_empty(groups.shape, dtype=torch.int8),
            groups.new_empty((groups.shape[0], 1), dtype=torch.float32))


@torch.library.register_fake("repro_torch::dequantize", lib=_LIB)
def _dequantize_fake(q, scales, out_dtype):
    _check_groups(q, "q")
    return q.new_empty(q.shape, dtype=out_dtype)


# (groups) -> (q, scales)
quantize_op = torch.ops.repro_torch.quantize.default
# (q, scales, out_dtype) -> out
dequantize_op = torch.ops.repro_torch.dequantize.default

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
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

GROUP = 1024
BLOCK_GROUPS = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

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
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"runs on cuda or cpu, not {dev}")
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel needs contiguous, 16-byte aligned "
                             "tensors")
    return True


def quantize(groups):
    """groups: (n_groups, 1024) fp32 or bf16.  Returns (q int8 of the same
    shape, scales (n_groups, 1) fp32)."""
    _check_groups(groups, "groups")
    if groups.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {groups.dtype}")
    if not _cuda_ready(groups):
        return quantize_reference(groups)
    n = groups.shape[0]
    q = torch.empty(groups.shape, dtype=torch.int8, device=groups.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=groups.device)
    fn = _kernel("quantize")
    with torch.cuda.device(groups.device):
        stream = torch.cuda.current_stream(groups.device).cuda_stream
        err = fn(groups.data_ptr(), q.data_ptr(), scales.data_ptr(), n,
                 _DTYPE_CODES[groups.dtype], stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
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
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if not _cuda_ready(q, scales):
        return dequantize_reference(q, scales, out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    fn = _kernel("dequantize")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), q.shape[0],
                 _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"dequantize kernel launch failed: cudaError "
                           f"{err}")
    global DEQUANT_LAUNCHES
    DEQUANT_LAUNCHES += 1
    return out


def _kernel(name):
    fn = getattr(build.load("quantize"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_void_p]
    return fn

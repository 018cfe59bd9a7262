"""Model-facing wrappers over the port's kernels.

``flash_attention`` is the counterpart of the JAX package's
``pallas_flash_attention`` (kernels/ops.py), a ``torch.autograd.Function``
as that one is a ``custom_vjp``: the forward kernel saves (q, k, v, out,
lse), the backward computes ``delta = rowsum(dO * O)`` in fp32 and runs the
two backward kernels.  The TPU wrapper transposes to (B, n_kv, G, S, D) and
zero-pads D to 128 for the TPU's (8, 128) tiling; the Hopper kernels read
permuted views through their strides and take any D <= 256, so here the
layout change is a free view.

``quantize`` / ``dequantize`` mirror the JAX wrappers of the same names:
flatten, pad to whole blocks of 8 x 1024 values, and carry the original
shape, dtype and length in ``meta``.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import flash_bwd, flash_fwd
from .quantize import BLOCK_GROUPS, GROUP
from .quantize import dequantize as _dequantize_groups
from .quantize import quantize as _quantize_groups


def _five_d(x, n_kv):
    B, S, Hq, D = x.shape
    return x.reshape(B, S, n_kv, Hq // n_kv, D).permute(0, 2, 3, 1, 4)


def _four_d(x5):
    B, H, G, S, D = x5.shape
    return x5.permute(0, 3, 1, 2, 4).reshape(B, S, H * G, D)


class _FlashAttention(torch.autograd.Function):
    """q: (B, S, Hq, D); k, v: (B, Sk, n_kv, D) -> (B, S, Hq, D)."""

    @staticmethod
    def forward(ctx, q, k, v, n_kv, causal, window, prefix):
        out5, lse = flash_fwd(_five_d(q, n_kv), k.permute(0, 2, 1, 3),
                              v.permute(0, 2, 1, 3), causal=causal,
                              window=window, prefix=prefix,
                              scale=1.0 / math.sqrt(q.shape[-1]))
        out = _four_d(out5)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (n_kv, causal, window, prefix)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        n_kv, causal, window, prefix = ctx.mask
        do5 = _five_d(dout.contiguous(), n_kv)
        delta = (do5.float() * _five_d(out, n_kv).float()).sum(dim=-1)
        dq5, dk4, dv4 = flash_bwd(
            _five_d(q, n_kv), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            do5, lse, delta, causal=causal, window=window, prefix=prefix,
            scale=1.0 / math.sqrt(q.shape[-1]))
        return (_four_d(dq5).to(q.dtype), dk4.permute(0, 2, 1, 3).to(k.dtype),
                dv4.permute(0, 2, 1, 3).to(v.dtype), None, None, None, None)


def flash_attention(q, k, v, n_kv: int, causal: bool = True, window: int = 0,
                    prefix: int = 0, bq: int = 256, bk: int = 512):
    """q: (B, S, Hq, D); k, v: (B, Sk, n_kv, D) -> (B, S, Hq, D), with a
    gradient through the backward kernels.

    ``bq``/``bk`` are accepted for the JAX signature; the kernels keep their
    own tile sizes."""
    del bq, bk
    return _FlashAttention.apply(q, k, v, n_kv, causal, window, prefix)


# ----------------------------- quantisation -----------------------------

def quantize(x: torch.Tensor):
    """-> (q int8 (n_groups, 1024), scales (n_groups, 1) fp32, meta), where
    meta carries the original shape, dtype and length for ``dequantize``.
    fp32 and bf16 values go to the kernel as they are; any other float
    dtype is widened to fp32 first."""
    meta = (tuple(x.shape), x.dtype, x.numel())
    flat = x.reshape(-1)
    if flat.dtype not in (torch.float32, torch.bfloat16):
        flat = flat.float()
    pad = (-flat.numel()) % (GROUP * BLOCK_GROUPS)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, s = _quantize_groups(flat.reshape(-1, GROUP))
    return q, s, meta


def dequantize(q: torch.Tensor, scales: torch.Tensor, meta) -> torch.Tensor:
    shape, dtype, n = meta
    out_dtype = dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    flat = _dequantize_groups(q, scales, out_dtype).reshape(-1)
    return flat[:n].reshape(shape).to(dtype)

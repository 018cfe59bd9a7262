"""Model-facing wrappers over the port's kernels.

``flash_attention`` is the counterpart of the JAX package's
``pallas_flash_attention`` (kernels/ops.py), a ``torch.autograd.Function``
as that one is a ``custom_vjp``: the forward kernel saves (q, k, v, out,
lse), the backward computes ``delta = rowsum(dO * O)`` in fp32 and runs the
two backward kernels.  The TPU wrapper transposes to (B, n_kv, G, S, D) and
zero-pads D to 128 for the TPU's (8, 128) tiling; the Hopper kernels read
permuted views through their strides and take any D <= 256, so here the
layout change is a free view.  The kernels are reached through their
custom ops (``flash_fwd_op``, ``flash_bwd_op``, ``quantize_op``,
``dequantize_op``), so on the meta device only their fakes run.

``quantize`` / ``dequantize`` mirror the JAX wrappers of the same names:
flatten, pad to whole blocks of 8 x 1024 values, and carry the original
shape, dtype and length in ``meta``.

``checksum_array`` is bit-identical to ``core.integrity.checksum`` of a
tensor's bytes, length mix included; unlike the JAX wrapper, which goes
through ``np.asarray`` first, it reads a CUDA tensor's bytes where they lie.
``shard_pack`` / ``shard_unpack`` mirror the JAX wrappers: the byte view,
zero padding to whole stripes of ``width`` cells, and ``meta =
(orig_nbytes, cell_bytes, width)``.
"""
from __future__ import annotations

import math

import torch

from . import shard_pack as _sp
from .checksum import byte_view, checksum
from .flash_attention import flash_bwd_op, flash_fwd_op
from .quantize import BLOCK_GROUPS, GROUP, dequantize_op, quantize_op


def _five_d(x, n_kv):
    B, S, Hq, D = x.shape
    return x.reshape(B, S, n_kv, Hq // n_kv, D).permute(0, 2, 3, 1, 4)


def _four_d(x5):
    B, H, G, S, D = x5.shape
    return x5.permute(0, 3, 1, 2, 4).reshape(B, S, H * G, D)


class _FlashAttention(torch.autograd.Function):
    """q: (B, S, Hq, D); k, v: (B, Sk, n_kv, D) -> (B, S, Hq, D)."""

    @staticmethod
    def forward(ctx, q, k, v, n_kv, causal, window, prefix, scale):
        out5, lse = flash_fwd_op(_five_d(q, n_kv), k.permute(0, 2, 1, 3),
                                 v.permute(0, 2, 1, 3), causal, window,
                                 prefix, scale)
        out = _four_d(out5)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (n_kv, causal, window, prefix, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        n_kv, causal, window, prefix, scale = ctx.mask
        do5 = _five_d(dout.contiguous(), n_kv)
        delta = (do5.float() * _five_d(out, n_kv).float()).sum(dim=-1)
        dq5, dk4, dv4 = flash_bwd_op(
            _five_d(q, n_kv), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            do5, lse, delta, causal, window, prefix, scale)
        return (_four_d(dq5).to(q.dtype), dk4.permute(0, 2, 1, 3).to(k.dtype),
                dv4.permute(0, 2, 1, 3).to(v.dtype), None, None, None, None,
                None)


def flash_attention(q, k, v, n_kv: int, causal: bool = True, window: int = 0,
                    prefix: int = 0, bq: int = 256, bk: int = 512,
                    scale: float | None = None):
    """q: (B, S, Hq, D); k, v: (B, Sk, n_kv, D) -> (B, S, Hq, D), with a
    gradient through the backward kernels; ``scale`` the softmax scale,
    None for 1/sqrt(D).

    ``bq``/``bk`` are accepted for the JAX signature; the kernels keep their
    own tile sizes."""
    del bq, bk
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, n_kv, causal, window, prefix,
                                 scale)


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
    q, s = quantize_op(flat.reshape(-1, GROUP))
    return q, s, meta


def dequantize(q: torch.Tensor, scales: torch.Tensor, meta) -> torch.Tensor:
    shape, dtype, n = meta
    out_dtype = dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    flat = dequantize_op(q, scales, out_dtype).reshape(-1)
    return flat[:n].reshape(shape).to(dtype)


# ----------------------------- checksum -----------------------------

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4B5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def checksum_array(x: torch.Tensor) -> int:
    """The checksum of a contiguous tensor's bytes, bit-identical to
    ``core.integrity.checksum``: the kernel's weighted sum (the twin's on
    the CPU) XOR the low 32 bits of ``splitmix64(nbytes)``."""
    nbytes = x.numel() * x.element_size()
    return (int(checksum(x)) & 0xFFFFFFFF) ^ (_splitmix64(nbytes)
                                              & 0xFFFFFFFF)


# ----------------------------- stripe packing -----------------------------

def shard_pack(x: torch.Tensor, width: int, cell_bytes: int = 1 << 16):
    """Reorder a tensor's bytes into per-target stripe buffers.

    -> (packed (width, cells_per_target, cell_rows, 128) int32, meta) on
    ``x``'s device.  cell_bytes must be a multiple of 512 (128 words)."""
    if cell_bytes % (_sp.CELL_COLS * 4):
        raise ValueError(f"cell_bytes {cell_bytes} is not a multiple of "
                         f"{_sp.CELL_COLS * 4}")
    u8 = byte_view(x.contiguous())
    nbytes = u8.numel()
    pad = (-nbytes) % (cell_bytes * width)
    if pad or u8.storage_offset() % 4:
        u8 = torch.cat([u8, u8.new_zeros(pad)])
    cells = u8.view(torch.int32).view(-1, cell_bytes // (_sp.CELL_COLS * 4),
                                      _sp.CELL_COLS)
    return _sp.shard_pack(cells, width), (nbytes, cell_bytes, width)


def shard_unpack(packed: torch.Tensor, meta) -> torch.Tensor:
    """Inverse: -> the original bytes as uint8[orig_nbytes], on the packed
    buffer's device."""
    orig_nbytes, _cell_bytes, _width = meta
    cells = _sp.shard_unpack(packed)
    return cells.reshape(-1).view(torch.uint8)[:orig_nbytes]

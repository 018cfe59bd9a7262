"""Decode attention over a ring KV cache: the Hopper kernel's wrapper and its
plain twin.

``decode_attn`` is the work of ``models.layers.attention_decode`` after its
three projections: rope on q and on the new k at ``pos``, the new k and v
written into slot ``pos % S_cache`` of the caches in place, and attention
of the one query position over the cache's valid slots (slot j is valid iff
j <= pos or pos >= S_cache).  On a CUDA tensor it launches
``csrc/decode_attn.cu`` (one kernel, and a second that merges the splits
of the valid slots where there is more than one) or raises; on a CPU
tensor it computes the plain twin (``decode_attention_reference``: the
body ``attention_decode`` had before the kernel, unchanged), which the
card's tests also use as the oracle.  ``DECODE_ATTN_LAUNCHES`` counts the
calls that launched the kernel, and ``ROUTE_LAUNCHES`` the same by route.

Two routes, chosen from the dtype and the GQA group G alone (``_route``):
``"simt"`` (fp32, and bf16 with G <= 4: the CUDA cores, every row read
once for up to 4 query heads) and ``"mma"`` (bf16 with G > 4, up to 16:
``mma.sync`` over the group, where the CUDA cores would fall behind the
bytes).  ``decode_splits`` picks the number of splits from the shapes
(rows, kv heads, group chunks, valid slots) and the card's SM count.

``decode_attn_op`` is the entry point registered as the PyTorch custom op
``repro_torch::decode_attn``, which ``attention_decode`` calls: on a CUDA
or CPU tensor it runs ``decode_attn``; on a meta tensor only its fake runs
(an output of q's shape and dtype; the caches are left as they are).  Its
FLOP formula counts the two products over the valid slots, and
``decode_attn_bytes`` the bytes it must move, which ``launch/op_cost.py``
charges in place of its operands' whole sizes.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import build
from .attention_math import gqa_scores_softmax_v, rope, rope_freqs
from .flash_attention import _DTYPE_CODES, MAX_HEAD_DIM, NUM_SMS

MMA_MAX_GROUP = 16
SIMT_GROUP_CHUNK = 4
# the fewest valid slots a split takes (the tensor-core route's tile)
SPLIT_ROWS = 64
_ROUTE_CODES = {"simt": 0, "mma": 1}

DECODE_ATTN_LAUNCHES = 0
ROUTE_LAUNCHES = {"simt": 0, "mma": 0}

# (device, D, rotary_pct, rope_theta) -> the fp32 inverse frequencies on
# the card, made once: the decode path then copies nothing to the card.
_INV_FREQ: dict = {}


def decode_attention_reference(q, k, v, cache_k, cache_v, pos, rotary_pct,
                               rope_theta, rope_bf16, scale=None):
    """Plain torch: ``layers.attention_decode``'s body after the
    projections.  q: (B, 1, Hq, D); k, v: (B, 1, Hkv, D); the caches (B,
    S_cache, Hkv, D), written in place.  Returns (B, 1, Hq, D) in q's
    dtype.  ``rope_bf16``: rope's products in x's dtype (``layers``'
    ``_NORM_BF16``); ``scale``: the softmax scale, None for 1/sqrt(D)."""
    B = q.shape[0]
    S_cache = cache_k.shape[1]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=q.device)
    q = rope(q, posv, rotary_pct, rope_theta, rope_bf16)
    k = rope(k, posv, rotary_pct, rope_theta, rope_bf16)
    slot = pos % S_cache
    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)
    # Ring buffer: slots beyond `pos` are unwritten until the buffer
    # wraps (SWA archs allocate cache_len == window, so wrapping IS the
    # sliding window; RoPE is baked into cached k, and softmax is
    # permutation-invariant over slots, so ring order is harmless).
    idx = torch.arange(S_cache, device=q.device)
    valid = (idx <= pos) | (pos >= S_cache)
    mask = torch.where(valid, 0.0, -1e30).to(torch.float32)[
        None, None, None]
    return gqa_scores_softmax_v(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                                mask, cache_k.shape[2], scale)


def _check(q, k, v, cache_k, cache_v, pos):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or cache_k.dim() != 4:
        raise ValueError("decode_attn takes q (B, 1, Hq, D), k, v (B, 1, "
                         "Hkv, D) and caches (B, S_cache, Hkv, D)")
    B, one, Hq, D = q.shape
    _, S, Hkv, _ = cache_k.shape
    if one != 1 or cache_v.shape != cache_k.shape \
            or tuple(k.shape) != (B, 1, Hkv, D) or k.shape != v.shape \
            or cache_k.shape[0] != B or cache_k.shape[3] != D \
            or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, caches "
                         f"{tuple(cache_k.shape)} {tuple(cache_v.shape)}")
    if not q.dtype == k.dtype == v.dtype == cache_k.dtype == cache_v.dtype:
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}, "
                         f"{cache_k.dtype}, {cache_v.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if not q.device == k.device == v.device == cache_k.device \
            == cache_v.device:
        raise ValueError("decode_attn's inputs lie on different devices")
    if D > MAX_HEAD_DIM or min(q.shape) < 1 or S < 1 or pos < 0:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, caches "
                         f"{tuple(cache_k.shape)}, pos {pos} (head dim <= "
                         f"{MAX_HEAD_DIM})")


def _route(dtype, G: int) -> str:
    """``"mma"`` for bf16 with G > 4, else ``"simt"``."""
    return "mma" if dtype == torch.bfloat16 and G > SIMT_GROUP_CHUNK \
        else "simt"


def _group_chunks(route: str, G: int) -> int:
    """Blocks a (row, kv head, split): the CUDA-core route takes at most 4
    query heads a block (G rounded up to a power of 2 below that), the
    tensor-core route all G."""
    if route == "mma":
        return 1
    chunk = SIMT_GROUP_CHUNK if G >= SIMT_GROUP_CHUNK \
        else 1 << (G - 1).bit_length()
    return -(-G // chunk)


def decode_splits(batch: int, kv_blocks: int, n_valid: int) \
        -> tuple[int, int]:
    """(splits, slots a split) of the ``n_valid`` valid slots, where
    ``batch * kv_blocks`` blocks cover the rows and kv heads (and group
    chunks): the fewest splits that give 2 blocks an SM (``NUM_SMS``), at
    most one per ``SPLIT_ROWS`` slots; each split a whole number of
    ``SPLIT_ROWS``, the last one the rest."""
    want = -(-2 * NUM_SMS // (batch * kv_blocks))
    n = max(1, min(want, -(-n_valid // SPLIT_ROWS)))
    per_split = -(-n_valid // n)
    rows = -(-per_split // SPLIT_ROWS) * SPLIT_ROWS
    return -(-n_valid // rows), rows


def _inv_freq(device, D: int, pct: float, theta: float):
    """(the inverse frequencies on ``device``, or None, and rot)."""
    key = (device, D, pct, theta)
    got = _INV_FREQ.get(key)
    if got is None:
        inv = rope_freqs(D, pct, theta)
        got = (None, 0) if inv is None else (
            torch.from_numpy(np.ascontiguousarray(inv)).to(device),
            2 * inv.shape[0])
        _INV_FREQ[key] = got
    return got


def decode_attn(q, k, v, cache_k, cache_v, pos: int, rotary_pct: float,
                rope_theta: float, rope_bf16: bool,
                scale: float | None = None):
    """q: (B, 1, Hq, D); k, v: (B, 1, Hkv, D), before rope; cache_k,
    cache_v: (B, S_cache, Hkv, D), the new k/v written into slot
    ``pos % S_cache`` in place.  Returns (B, 1, Hq, D) in q's dtype.
    ``scale``: the softmax scale, None for 1/sqrt(D).
    On the card every operand must have a contiguous last dimension and
    16-byte aligned pointers and strides, and D * itemsize must be a
    multiple of 16."""
    _check(q, k, v, cache_k, cache_v, pos)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, cache_k, cache_v, pos,
                                          rotary_pct, rope_theta, rope_bf16,
                                          scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cuda or cpu, not {q.device}")
    B, _, Hq, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = Hq // Hkv
    route = _route(q.dtype, G)
    if G > MMA_MAX_GROUP and route == "mma":
        raise ValueError(f"decode_attn takes bf16 groups of at most "
                         f"{MMA_MAX_GROUP} query heads, not {G}")
    ept = 16 // q.element_size()
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    cks, cvs = cache_k.stride(), cache_v.stride()
    strides = (qs[0], qs[2], ks[0], ks[2], vs[0], vs[2], cks[0], cks[1],
               cks[2], cvs[0], cvs[1], cvs[2])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_k.data_ptr(),
            cache_v.data_ptr())
    if D % ept or any(s % ept for s in strides) or any(p % 16 for p in ptrs) \
            or qs[3] != 1 or ks[3] != 1 or vs[3] != 1 or cks[3] != 1 \
            or cvs[3] != 1:
        raise ValueError("decode_attn on the card needs contiguous last "
                         "dimensions, 16-byte aligned pointers and strides "
                         "and D * itemsize a multiple of 16")
    n_gc = _group_chunks(route, G)
    n_valid = min(pos + 1, S)
    n_split, split_rows = decode_splits(B, Hkv * n_gc, n_valid)
    inv, rot = _inv_freq(q.device, D, rotary_pct, rope_theta)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    part = torch.empty(B * Hq * n_split * (D + 2), dtype=torch.float32,
                       device=q.device) if n_split > 1 else None
    args = (ctypes.c_int64 * 23)(*strides, B, Hkv, G, D, S, pos, rot,
                                 n_split, split_rows, n_gc, int(rope_bf16))
    with torch.cuda.device(q.device):
        # the current stream's handle, without building a Stream object
        # (4 of the wrapper's ~47 us on an H100 host)
        stream = torch._C._cuda_getCurrentRawStream(q.device.index)
        err = _kernel()(*ptrs, out.data_ptr(),
                        None if part is None else part.data_ptr(),
                        None if inv is None else inv.data_ptr(), args,
                        _DTYPE_CODES[q.dtype], _ROUTE_CODES[route],
                        math.log2(math.e) / math.sqrt(D) if scale is None
                        else math.log2(math.e) * scale, stream)
    if err != 0:
        raise RuntimeError(f"decode_attn kernel launch failed ({route} "
                           f"route): cudaError {err}")
    global DECODE_ATTN_LAUNCHES
    DECODE_ATTN_LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def _kernel():
    fn = build.load("decode_attn").decode_attn
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
    return fn


# ----------------------------- cost -----------------------------

def decode_attn_flops(q_shape, S_cache: int, pos: int) -> int:
    """The two products (q.k, p.v) over the valid slots: 2 x 2 B Hq D
    FLOPs a slot."""
    B, _, Hq, D = q_shape
    return 2 * 2 * B * Hq * D * min(pos + 1, S_cache)


def decode_attn_bytes(q, k, v, cache_k, cache_v, pos, *args, **kwargs) \
        -> int:
    """The bytes the call must move: q read, each valid K and V row read
    once (the slot's as the new k/v), the slot written and the output."""
    B, _, Hq, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    row = B * Hkv * D * cache_k.element_size()
    return 2 * q.numel() * q.element_size() \
        + 2 * row * min(pos + 1, S) + 2 * row


# ----------------------------- custom op -----------------------------

# Registered as flash_attention.py registers its ops (see there): the
# wrapper for the CPU and CUDA keys, a fake for everything else.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("decode_attn(Tensor q, Tensor k, Tensor v, Tensor(a!) cache_k, "
            "Tensor(b!) cache_v, int pos, float rotary_pct, "
            "float rope_theta, bool rope_bf16, float? scale=None) -> "
            "Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("decode_attn", decode_attn, _key)


@torch.library.register_fake("repro_torch::decode_attn", lib=_LIB)
def _decode_attn_fake(q, k, v, cache_k, cache_v, pos, rotary_pct,
                      rope_theta, rope_bf16, scale=None):
    _check(q, k, v, cache_k, cache_v, pos)
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.decode_attn)
def _decode_attn_flops(q_shape, k_shape, v_shape, ck_shape, cv_shape, pos,
                       *args, out_shape=None, **kwargs) -> int:
    return decode_attn_flops(q_shape, ck_shape[1], pos)


# (q, k, v, cache_k, cache_v, pos, rotary_pct, rope_theta, rope_bf16
#  [, scale]) -> out
decode_attn_op = torch.ops.repro_torch.decode_attn.default

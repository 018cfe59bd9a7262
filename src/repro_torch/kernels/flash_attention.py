"""Flash-attention forward: the Hopper kernel's wrapper and its plain twin.

``flash_fwd`` is the counterpart of the JAX package's ``flash_fwd_pallas``
(kernels/flash_attention.py) with the same signature and 5-D layout.  On a
CUDA tensor it launches ``csrc/flash_fwd.cu`` (built by ``build.py``) or
raises; on a CPU tensor it computes ``flash_fwd_reference``, which
``chip_smoke.py`` also uses as the on-card oracle.  ``LAUNCHES`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG = -1e30
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0


def flash_fwd_reference(q, k, v, *, causal=True, window=0, prefix=0,
                        scale=None):
    """Plain torch with the TPU kernel's arithmetic: fp32 scores with the
    finite -1e30 mask sentinel, fp32 softmax and P.V, ``out`` cast to q's
    dtype, fp32 ``lse``."""
    B, H, G, S, D = q.shape
    Sk = k.shape[2]
    scale = scale if scale else 1.0 / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    allow = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        allow &= ki <= qi
    if window:
        allow &= (qi - ki) < window
    if prefix:
        allow |= ki < prefix
    s = s.masked_fill(~allow, NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf) / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def _check(q, k, v):
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd takes q (B, n_kv, G, S, D) and k, v "
                         "(B, n_kv, Sk, D)")
    B, H, G, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != H \
            or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v lie on different devices")
    if D > MAX_HEAD_DIM or min(q.shape) < 1 or k.shape[2] < 1:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} (head dim <= {MAX_HEAD_DIM})")


def flash_fwd(q, k, v, *, causal=True, window=0, prefix=0, scale=None):
    """q: (B, n_kv, G, S, D); k, v: (B, n_kv, Sk, D), any strides with a
    contiguous last dimension.  Returns (out (B, n_kv, G, S, D) in q's
    dtype, lse (B, n_kv, G, S) fp32).  ``scale`` defaults to 1/sqrt(D)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, window=window,
                                   prefix=prefix, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_fwd needs a contiguous last dimension")
    B, H, G, S, D = q.shape
    Sk = k.shape[2]
    # out lives in (B, S, n_kv, G, D) memory, so the model's (B, S, Hq, D)
    # view of it is free.
    out = torch.empty((B, S, H, G, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 3, 1, 4)
    lse = torch.empty((B, H, G, S), dtype=torch.float32, device=q.device)
    dims = (ctypes.c_int64 * 6)(B, H, G, S, Sk, D)
    strides = (ctypes.c_int64 * 14)(*q.stride()[:4], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:4])
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dims, strides, _DTYPE_CODES[q.dtype],
                 int(causal), int(window), int(prefix),
                 float(scale if scale else 1.0 / math.sqrt(D)), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def _kernel():
    fn = build.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
    return fn

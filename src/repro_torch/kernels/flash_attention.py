"""Flash attention, forward and backward: the Hopper kernels' wrappers and
their plain twins.

``flash_fwd`` and ``flash_bwd`` are the counterparts of the JAX package's
``flash_fwd_pallas`` and ``flash_bwd_pallas`` (kernels/flash_attention.py)
with the same 5-D layout.  On a CUDA tensor each launches its kernels
(``csrc/flash_fwd.cu``; ``csrc/flash_bwd.cu``, a dq pass and a dk/dv pass;
bf16 on the tensor cores, fp32 on the CUDA cores) or raises; on a CPU
tensor each computes its plain twin (``flash_fwd_reference``,
``flash_bwd_reference``), which ``chip_smoke.py`` also uses as the
on-card oracle.  ``LAUNCHES`` (forward), ``BWD_DQ_LAUNCHES`` and
``BWD_DKV_LAUNCHES`` count kernel launches and nothing else.

``flash_fwd_op`` and ``flash_bwd_op`` are the same entry points registered
as PyTorch custom ops (``repro_torch::flash_fwd``, ``::flash_bwd``), which
the model calls through ``ops.flash_attention``: on a CUDA or CPU tensor
the op runs the wrapper above; on a meta tensor only its fake runs, which
makes outputs of the kernel's shapes, dtypes and strides and computes
nothing.  Each op has a FLOP formula in ``torch.utils.flop_counter``'s
registry, over the (query, key) pairs the mask allows
(``allowed_pairs``), so a counter sees one kernel as one unit of cost, as
the reference's dry-run sees the Pallas custom call.  The wrappers
themselves still refuse a meta tensor.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import build

NEG = -1e30
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0


def _allow(S, Sk, causal, window, prefix, device):
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    allow = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        allow &= ki <= qi
    if window:
        allow &= (qi - ki) < window
    if prefix:
        allow |= ki < prefix
    return allow


def _masked_scores(q, k, causal, window, prefix, scale):
    """fp32 scores ``q.k * scale`` with the finite -1e30 mask sentinel."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) * scale
    allow = _allow(q.shape[3], k.shape[2], causal, window, prefix, q.device)
    return s.masked_fill(~allow, NEG)


def flash_fwd_reference(q, k, v, *, causal=True, window=0, prefix=0,
                        scale=None):
    """Plain torch with the TPU kernel's arithmetic: fp32 scores with the
    finite -1e30 mask sentinel, fp32 softmax and P.V, ``out`` cast to q's
    dtype, fp32 ``lse``."""
    D = q.shape[-1]
    scale = scale if scale else 1.0 / math.sqrt(D)
    vf = v.float()
    s = _masked_scores(q, k, causal, window, prefix, scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf) / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def flash_bwd_reference(q, k, v, do, lse, delta, *, causal=True, window=0,
                        prefix=0, scale=None):
    """Plain torch with the TPU kernels' arithmetic, in fp32: p recomputed
    from ``lse``, ``ds = p * (dO.v - delta) * scale``, dq = ds.k, and dk/dv
    summed over the G query groups.  Returns (dq, dk, dv) in q's, k's and
    v's dtypes."""
    D = q.shape[-1]
    scale = scale if scale else 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = _masked_scores(q, k, causal, window, prefix, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _check_cuda(*ts):
    if ts[0].device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{ts[0].device}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash attention needs a contiguous last dimension")


def flash_fwd(q, k, v, *, causal=True, window=0, prefix=0, scale=None):
    """q: (B, n_kv, G, S, D); k, v: (B, n_kv, Sk, D), any strides with a
    contiguous last dimension.  Returns (out (B, n_kv, G, S, D) in q's
    dtype, lse (B, n_kv, G, S) fp32).  ``scale`` defaults to 1/sqrt(D)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, window=window,
                                   prefix=prefix, scale=scale)
    _check_cuda(q, k, v)
    B, H, G, S, D = q.shape
    Sk = k.shape[2]
    scale = float(scale if scale else 1.0 / math.sqrt(D))
    # out lives in (B, S, n_kv, G, D) memory, so the model's (B, S, Hq, D)
    # view of it is free.
    out = torch.empty((B, S, H, G, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 3, 1, 4)
    lse = torch.empty((B, H, G, S), dtype=torch.float32, device=q.device)
    dims = (ctypes.c_int64 * 6)(B, H, G, S, Sk, D)
    strides = (ctypes.c_int64 * 14)(*q.stride()[:4], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:4])
    fn = _fwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dims, strides, _DTYPE_CODES[q.dtype],
                 int(causal), int(window), int(prefix), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def flash_bwd(q, k, v, do, lse, delta, *, causal=True, window=0, prefix=0,
              scale=None):
    """Gradients of ``flash_fwd``.  q, do: (B, n_kv, G, S, D); k, v:
    (B, n_kv, Sk, D), any strides with a contiguous last dimension; lse,
    delta: (B, n_kv, G, S) fp32, ``delta = rowsum(dO * O)``.  Returns (dq in
    q's layout and dtype, dk, dv (B, n_kv, Sk, D) in k's and v's dtypes)."""
    _check(q, k, v)
    B, H, G, S, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, G, S) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {(B, H, G, S)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not q.device == do.device == lse.device == delta.device:
        raise ValueError("flash_bwd's inputs lie on different devices")
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                   window=window, prefix=prefix, scale=scale)
    _check_cuda(q, k, v, do)
    lse, delta = lse.contiguous(), delta.contiguous()
    Sk = k.shape[2]
    # dq lives in (B, S, n_kv, G, D) memory and dk/dv in (B, Sk, n_kv, D),
    # so the model's (B, S, H, D) views of them are free.
    dq = torch.empty((B, S, H, G, D), dtype=q.dtype,
                     device=q.device).permute(0, 2, 3, 1, 4)
    dk = torch.empty((B, Sk, H, D), dtype=k.dtype,
                     device=q.device).permute(0, 2, 1, 3)
    dv = torch.empty((B, Sk, H, D), dtype=v.dtype,
                     device=q.device).permute(0, 2, 1, 3)
    dims = (ctypes.c_int64 * 6)(B, H, G, S, Sk, D)
    strides = (ctypes.c_int64 * 24)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *do.stride()[:4],
        *dq.stride()[:4], *dk.stride()[:3], *dv.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dims, strides, _DTYPE_CODES[q.dtype], int(causal),
            int(window), int(prefix),
            float(scale if scale else 1.0 / math.sqrt(D)))
    global BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel("flash_bwd_dq")(*args, stream)
        if err != 0:
            raise RuntimeError(f"flash_bwd dq kernel launch failed: "
                               f"cudaError {err}")
        BWD_DQ_LAUNCHES += 1
        err = _bwd_kernel("flash_bwd_dkv")(*args, stream)
        if err != 0:
            raise RuntimeError(f"flash_bwd dk/dv kernel launch failed: "
                               f"cudaError {err}")
        BWD_DKV_LAUNCHES += 1
    return dq, dk, dv


def _fwd_kernel():
    fn = build.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
    return fn


def _bwd_kernel(name):
    fn = getattr(build.load("flash_bwd"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
    return fn


# ----------------------------- custom ops -----------------------------

def allowed_pairs(S: int, Sk: int, causal: bool, window: int,
                  prefix: int) -> int:
    """The (query, key) pairs that ``_allow`` lets through, row by row in
    closed form: keys lo..hi of the causal / window band, plus the prefix
    keys outside it."""
    qi = np.arange(S, dtype=np.int64)
    hi = np.minimum(qi, Sk - 1) if causal else np.full(S, Sk - 1, np.int64)
    lo = np.maximum(qi - window + 1, 0) if window else np.zeros(S, np.int64)
    n = np.maximum(hi - lo + 1, 0)
    p = min(prefix, Sk)
    if p:
        n += p - np.maximum(np.minimum(hi, p - 1) - lo + 1, 0)
    return int(n.sum())


def attention_flops(q_shape, Sk: int, causal: bool, window: int,
                    prefix: int, products: int) -> int:
    """``products`` products of 2 B Hq D FLOPs a pair the mask allows, for
    q of shape (B, n_kv, G, S, D): the forward does 2 (q.k, p.v), the
    backward pair 7 (dq 3: q.k, dO.v, ds.k; dk/dv 4: q.k, dO.v, ds.q,
    p.dO)."""
    B, H, G, S, D = q_shape
    return products * 2 * B * H * G * D * allowed_pairs(S, Sk, causal,
                                                         window, prefix)


# The schemas are defined with ``torch.library.Library`` and the wrappers
# registered for the CPU and CUDA keys: the dispatcher then calls them with
# a few microseconds of overhead (``torch.library.custom_op`` added some
# 30 a call on an H100 host, PERF.md, which the host-bound steps would pay
# on every launch; ``chip_smoke.py`` times the op against the wrapper).
# No other device has a kernel, so a meta tensor reaches the fake and
# nothing else.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, int prefix, float scale) -> (Tensor, Tensor)")
_LIB.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor do, "
            "Tensor lse, Tensor delta, bool causal, int window, int prefix, "
            "float scale) -> (Tensor, Tensor, Tensor)")


def _flash_fwd_impl(q, k, v, causal, window, prefix, scale):
    return flash_fwd(q, k, v, causal=causal, window=window, prefix=prefix,
                     scale=scale)


def _flash_bwd_impl(q, k, v, do, lse, delta, causal, window, prefix, scale):
    return flash_bwd(q, k, v, do, lse, delta, causal=causal, window=window,
                     prefix=prefix, scale=scale)


for _key in ("CPU", "CUDA"):
    _LIB.impl("flash_fwd", _flash_fwd_impl, _key)
    _LIB.impl("flash_bwd", _flash_bwd_impl, _key)


@torch.library.register_fake("repro_torch::flash_fwd", lib=_LIB)
def _flash_fwd_fake(q, k, v, causal, window, prefix, scale):
    _check(q, k, v)
    B, H, G, S, D = q.shape
    out = q.new_empty((B, S, H, G, D)).permute(0, 2, 3, 1, 4)
    return out, q.new_empty((B, H, G, S), dtype=torch.float32)


@torch.library.register_fake("repro_torch::flash_bwd", lib=_LIB)
def _flash_bwd_fake(q, k, v, do, lse, delta, causal, window, prefix, scale):
    _check(q, k, v)
    B, H, G, S, D = q.shape
    Sk = k.shape[2]
    dq = q.new_empty((B, S, H, G, D)).permute(0, 2, 3, 1, 4)
    dk = k.new_empty((B, Sk, H, D)).permute(0, 2, 1, 3)
    dv = v.new_empty((B, Sk, H, D)).permute(0, 2, 1, 3)
    return dq, dk, dv


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, causal, window, prefix,
                     scale, out_shape=None, **kwargs) -> int:
    return attention_flops(q_shape, k_shape[2], causal, window, prefix, 2)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_flops(q_shape, k_shape, *args, out_shape=None,
                     **kwargs) -> int:
    causal, window, prefix = args[4:7]
    return attention_flops(q_shape, k_shape[2], causal, window, prefix, 7)


# (q, k, v, causal, window, prefix, scale) -> (out, lse)
flash_fwd_op = torch.ops.repro_torch.flash_fwd.default
# (q, k, v, do, lse, delta, causal, window, prefix, scale) -> (dq, dk, dv)
flash_bwd_op = torch.ops.repro_torch.flash_bwd.default

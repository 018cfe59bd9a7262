"""Mamba2's decode recurrence: the Hopper kernels' wrapper and its plain twin.

``ssd_decode`` is the work of ``models.ssm.ssd_decode_step`` between its two
projections: from the input projection's output to the pre-gate ``y``.  The
depthwise causal conv steps over the cached tail and the new x, B and C;
then, per head, the state takes one step of the recurrence,
``s' = exp(dt A) s + dt B x^T``, and is read out, ``y = C^T s' + D x``.  On
a CUDA tensor it launches ``csrc/ssd_decode.cu`` (a conv kernel, then a
state kernel), which update the conv tail and the fp32 state in place and
return them, or raises on what they do not take; on a CPU or meta tensor it
computes the plain twin (``ssd_decode_reference``: the body
``ssd_decode_step`` had before the kernels, unchanged), which returns new
tensors and which the card's tests also use as the oracle.
``SSD_DECODE_LAUNCHES`` counts the calls that launched the kernels.

The kernels round as the twin does everywhere but in the readout's sum over
N: the conv output and the new state are the twin's bits, ``y`` its value
up to that sum's order.  ``decode_p_slice`` splits a head's P columns over
blocks from the shapes alone.  ``causal_conv`` is the depthwise causal conv
that the prefill and the RG-LRU share with the twin.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .build import DTYPE_CODES, NUM_SMS

# the kernels' limits (csrc/ssd_decode.cu): the widest conv, the largest
# state size
MAX_CONV_WIDTH = 8
MAX_STATE = 1024
# the library function's arguments before the stream (``build.kernel``)
_ARGTYPES = (*[ctypes.c_void_p] * 11, ctypes.POINTER(ctypes.c_int64),
             ctypes.c_int)

SSD_DECODE_LAUNCHES = 0


def causal_conv(x, w, state=None, bias=None):
    """x: (B, S, D); w: (K, D) depthwise causal conv, plus ``bias`` (D,)
    where one is given.  If state (B, K-1, D) is given, runs in streaming
    mode and returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, :S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    if bias is not None:
        y = y + bias
    if state is None:
        return F.silu(y)
    return F.silu(y), xp[:, -(K - 1):]


def ssd_decode_reference(proj, params, state, conv_state):
    """Plain torch: ``ssd_decode_step``'s body between its projections.
    proj: (B, 1, 2 din + 2N + H), the input projection's [z, x, B, C, dt];
    params: the layer's ``conv``, ``conv_bias`` (optional), ``dt_bias``,
    ``a_log``, ``d_skip``; state: (B, H, N, P) fp32; conv_state: (B, K-1,
    din + 2N).  Returns (y (B, 1, din) in proj's dtype, before the gate;
    state', conv_state'), new tensors."""
    B = proj.shape[0]
    H, N, P = state.shape[1:]
    _, xin, Bc, Cc, dtp = torch.split(proj, [H * P, H * P, N, N, H], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, conv_state = causal_conv(conv_in, params["conv"], conv_state,
                                       params.get("conv_bias"))
    din = xin.shape[-1]
    xin, Bc, Cc = torch.split(conv_out, [din, N, N], dim=-1)
    dt = F.softplus(dtp.float() + params["dt_bias"])[:, 0]  # (B, H)
    A = -torch.exp(params["a_log"])
    a = torch.exp(dt * A)                                    # (B, H)
    xh = xin.reshape(B, H, P).float()
    Bv = Bc[:, 0].float()                                    # (B, N)
    Cv = Cc[:, 0].float()
    state = (state * a[..., None, None]
             + Bv[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", Cv, state)
    y = y + params["d_skip"][None, :, None] * xh
    return y.reshape(B, 1, H * P).to(proj.dtype), state, conv_state


def _check(proj, params, state, conv_state) -> None:
    if proj.dim() != 3 or state.dim() != 4 or conv_state.dim() != 3:
        raise ValueError("ssd_decode takes proj (B, 1, 2 din + 2N + H), "
                         "state (B, H, N, P) and conv_state (B, K-1, "
                         "din + 2N)")
    B, H, N, P = state.shape
    C = H * P + 2 * N
    K = params["conv"].shape[0]
    bias = params.get("conv_bias")
    if tuple(proj.shape) != (B, 1, 2 * H * P + 2 * N + H) \
            or tuple(conv_state.shape) != (B, K - 1, C) \
            or tuple(params["conv"].shape) != (K, C) \
            or (bias is not None and tuple(bias.shape) != (C,)) \
            or any(tuple(params[n].shape) != (H,)
                   for n in ("dt_bias", "a_log", "d_skip")):
        raise ValueError(
            f"shape mismatch: proj {tuple(proj.shape)}, state "
            f"{tuple(state.shape)}, conv_state {tuple(conv_state.shape)}, "
            f"conv {tuple(params['conv'].shape)}")


def decode_p_slice(B: int, H: int, P: int) -> int:
    """The head dims a block of the state kernel takes: the largest power
    of 2 up to 128 that divides P, halved down to 16 while B * H * (P /
    slice) blocks would give fewer than 2 an SM (``NUM_SMS``)."""
    s = next(w for w in (128, 64, 32, 16, 8, 4) if P % w == 0)
    while s > 16 and B * H * (P // s) < 2 * NUM_SMS:
        s //= 2
    return s


def ssd_decode(proj, params, state, conv_state):
    """proj: (B, 1, 2 din + 2N + H), the input projection's output; params:
    the layer's ``conv``, ``conv_bias`` (optional), ``dt_bias``, ``a_log``,
    ``d_skip``; state: (B, H, N, P) fp32; conv_state: (B, K-1, din + 2N).
    Returns (y (B, 1, din) in proj's dtype, before the gate; state,
    conv_state).  On the card the state and the conv tail are updated in
    place and returned; on the CPU and on meta the twin's new tensors."""
    _check(proj, params, state, conv_state)
    if proj.device.type == "meta" or not build.on_card(proj.device,
                                                       "ssd_decode"):
        return ssd_decode_reference(proj, params, state, conv_state)
    return _launch(proj, params, state, conv_state)


def _launch(proj, params, state, conv_state):
    """The card branch of ``ssd_decode``: both kernels on proj's device and
    current stream, the state and the conv tail written in place."""
    B, H, N, P = state.shape
    din, K = H * P, params["conv"].shape[0]
    dt = proj.dtype
    bias = params.get("conv_bias")
    tensors = [proj, conv_state, params["conv"], state, params["dt_bias"],
               params["a_log"], params["d_skip"]] \
        + ([] if bias is None else [bias])
    if any(t.device != proj.device for t in tensors):
        raise ValueError("ssd_decode's inputs lie on different devices")
    if dt not in DTYPE_CODES or conv_state.dtype != dt \
            or params["conv"].dtype != dt \
            or (bias is not None and bias.dtype != dt) \
            or state.dtype != torch.float32 \
            or any(params[n].dtype != torch.float32
                   for n in ("dt_bias", "a_log", "d_skip")):
        raise ValueError(
            f"ssd_decode on the card takes proj, the conv tail, taps and "
            f"bias in one of {sorted(map(str, DTYPE_CODES))} and an fp32 "
            f"state, dt_bias, a_log and d_skip; got proj {dt}, conv_state "
            f"{conv_state.dtype}, conv {params['conv'].dtype}, state "
            f"{state.dtype}")
    if P % 4 or N > MAX_STATE or not 2 <= K <= MAX_CONV_WIDTH \
            or not state.is_contiguous() or state.data_ptr() % 16 \
            or proj.stride(2) != 1 or conv_state.stride(2) != 1 \
            or not params["conv"].is_contiguous() \
            or any(not params[n].is_contiguous()
                   for n in ("dt_bias", "a_log", "d_skip")) \
            or (bias is not None and not bias.is_contiguous()):
        raise ValueError(
            f"ssd_decode on the card needs P a multiple of 4, N <= "
            f"{MAX_STATE}, a conv width in 2..{MAX_CONV_WIDTH}, a "
            f"contiguous 16-byte aligned state and contiguous last "
            f"dimensions; got state {tuple(state.shape)} with strides "
            f"{state.stride()}, conv width {K}")
    conv_out = torch.empty((B, din + 2 * N), dtype=dt, device=proj.device)
    y = torch.empty((B, 1, din), dtype=dt, device=proj.device)
    ps, cs = proj.stride(), conv_state.stride()
    args = (ctypes.c_int64 * 10)(B, H, N, P, K, decode_p_slice(B, H, P),
                                 ps[0], ps[0], cs[0], cs[1])
    item = proj.element_size()
    build.launch(build.kernel("ssd_decode", "ssd_decode", _ARGTYPES),
                 proj.device, proj.data_ptr() + din * item,
                 proj.data_ptr() + (2 * din + 2 * N) * item,
                 conv_state.data_ptr(), params["conv"].data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 params["dt_bias"].data_ptr(), params["a_log"].data_ptr(),
                 params["d_skip"].data_ptr(), state.data_ptr(),
                 conv_out.data_ptr(), y.data_ptr(), args, DTYPE_CODES[dt],
                 what="ssd_decode")
    global SSD_DECODE_LAUNCHES
    SSD_DECODE_LAUNCHES += 1
    return y, state, conv_state

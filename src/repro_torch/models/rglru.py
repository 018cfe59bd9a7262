"""Griffin / RecurrentGemma recurrent blocks (RG-LRU) in torch.

Counterpart of the JAX package's models/rglru.py.  Block: x -> {branch A:
linear -> causal conv1d -> RG-LRU} * {branch B: linear -> gelu} -> out-proj.
The RG-LRU recurrence per channel:

    r_t = sigmoid(W_r x_t + b_r)          (recurrence gate)
    i_t = sigmoid(W_i x_t + b_i)          (input gate)
    a_t = a ^ (c * r_t)                   (a = sigmoid(Lambda), c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill evaluate the linear recurrence with a log-depth scan
(``_linear_scan_assoc``): ceil(log2 S) doubling steps of whole-tensor
products where the reference takes ``lax.associative_scan``; decode is the
O(1) step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _dtype, _gelu, _init, init_device
from .ssm import _causal_conv

_C = 8.0


def init_rglru_block(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = _dtype(cfg)
    f32 = dict(dtype=torch.float32, device=init_device(gen))
    return {
        "w_branch": _init(gen, (d, w), dtype=dt),
        "w_gate_branch": _init(gen, (d, w), dtype=dt),
        "conv": _init(gen, (cfg.conv_width, w), scale=0.5, dtype=dt),
        "w_r": _init(gen, (w, w), scale=0.02, dtype=dt),
        "b_r": torch.zeros((w,), **f32),
        "w_i": _init(gen, (w, w), scale=0.02, dtype=dt),
        "b_i": torch.zeros((w,), **f32),
        "lam": torch.full((w,), 2.0, **f32),     # sigmoid(2) ~ .88 decay
        "w_out": _init(gen, (w, d), dtype=dt),
    }


def _rglru_coeffs(params, x):
    """x: (B, S, w) -> (a_t, b_t) of the recurrence h = a*h + b, fp32
    throughout (the gate products too, as in the reference)."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_r"].float() + params["b_r"])
    i = torch.sigmoid(xf @ params["w_i"].float() + params["b_i"])
    log_a_base = F.logsigmoid(params["lam"])                 # (w,)
    log_a = _C * r * log_a_base                              # (B, S, w)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def _linear_scan_assoc(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t along dim 1.

    Hillis-Steele doubling with the reference's combine
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): after the step of stride k,
    element t holds the composition of elements t-2k+1 .. t.  Every a_t
    lies in (0, 1), so no product overflows; the result differs from
    ``lax.associative_scan``'s odd/even recursion only by fp32
    reassociation."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S, k = a.shape[1], 1
    while k < S:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        if 2 * k < S:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_block(params: dict, x: torch.Tensor, cfg,
                state: torch.Tensor | None = None,
                conv_state: torch.Tensor | None = None):
    """x: (B, S, d) -> (y (B, S, d), h_final (B, w) fp32, conv_state').
    state: (B, w) recurrent carry (None = zeros)."""
    raw = x @ params["w_branch"]
    K = params["conv"].shape[0]
    if conv_state is None:
        branch = _causal_conv(raw, params["conv"])
        # conv tail for the prefill -> decode handoff (pre-conv inputs)
        pad = raw.new_zeros((raw.shape[0], max(0, K - 1 - raw.shape[1]),
                             raw.shape[2]))
        new_conv = torch.cat([pad, raw[:, -(K - 1):]], dim=1)
    else:
        branch, new_conv = _causal_conv(raw, params["conv"], conv_state)
    a, b = _rglru_coeffs(params, branch)
    h = _linear_scan_assoc(a, b, h0=None if state is None else state.float())
    gate = _gelu((x @ params["w_gate_branch"]).float())
    y = (h * gate).to(x.dtype) @ params["w_out"]
    return y, h[:, -1], new_conv


def rglru_decode_step(params: dict, x: torch.Tensor, cfg,
                      state: torch.Tensor, conv_state: torch.Tensor):
    """One-token step.  x: (B, 1, d); state: (B, w)."""
    return rglru_block(params, x, cfg, state=state, conv_state=conv_state)

"""Mamba2 / SSD (state-space duality) blocks in torch.

Counterpart of the JAX package's models/ssm.py.  Per head h, with scalar
decay a_t = exp(dt_t * A_h):

    s_t = a_t * s_{t-1} + dt_t * B_t x_t^T        (s: (N, P) state)
    y_t = C_t^T s_t + D_h x_t

Training and prefill take the chunked block decomposition (arXiv:2405.21060):
quadratic work within chunks of at most ``ssm_chunk`` steps, masked by the
decay kernel, and a linear recurrence over the chunk states.  The
reference's ``lax.scan`` over chunks is a Python loop here (at most 16
chunks at the training length).  Decode is the O(1) recurrence on a
(B, H, N, P) state.  ``jax.nn.softplus`` is ``logaddexp(x, 0)`` where
``F.softplus`` returns x above 20: they differ by < 2e-9.

``cfg.ssm_conv_bias`` adds a bias to the depthwise conv (granite-4.0-h),
and the gated norm takes ``cfg.rms_eps``.  ``SSD_CALLS`` counts the
prefill (``ssd_forward``) and decode (``ssd_decode_step``) calls, on the
host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _dtype, _init, init_device, rms_norm

SSD_CALLS = {"prefill": 0, "decode": 0}


def init_ssm(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    din = cfg.ssm_expand * d
    H = cfg.ssm_heads
    N = cfg.ssm_state
    dt = _dtype(cfg)
    f32 = dict(dtype=torch.float32, device=init_device(gen))
    p = {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": _init(gen, (d, 2 * din + 2 * N + H), dtype=dt),
        "conv": _init(gen, (cfg.conv_width, din + 2 * N), scale=0.5,
                      dtype=dt)}
    if cfg.ssm_conv_bias:
        p["conv_bias"] = _init(gen, (din + 2 * N,), scale=0.5, dtype=dt)
    return p | {
        "a_log": torch.full((H,), -0.5, **f32),
        "d_skip": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "w_out": _init(gen, (din, d), dtype=dt),
        "out_norm": torch.ones((din,), dtype=dt, device=init_device(gen)),
    }


def _split_proj(cfg, proj):
    """-> (z, x, B, C, dt) of the fused input projection."""
    din = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    return torch.split(proj, [din, din, N, N, cfg.ssm_heads], dim=-1)


def _causal_conv(x, w, state=None, bias=None):
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


def _segsum(log_a):
    """log_a: (..., Q).  Returns (..., Q, Q) with L[i, j] = sum_{j<k<=i}
    log_a_k for i >= j, -inf above the diagonal (masked before any exp, so
    the backward pass never meets inf)."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(Q, device=log_a.device)
    lower = idx[:, None] >= idx[None, :]
    return torch.where(lower, diff, torch.full_like(diff, -torch.inf))


def chunk_len(S: int, ssm_chunk: int) -> int:
    """The largest chunk <= ssm_chunk that divides S (production shapes
    divide exactly; ragged test prompts degrade gracefully)."""
    return next(q for q in range(min(ssm_chunk, S), 0, -1) if S % q == 0)


def ssd_forward(params: dict, x: torch.Tensor, cfg,
                initial_state: torch.Tensor | None = None):
    """x: (B, S, d) -> (y (B, S, d), final_state (B, H, N, P) fp32,
    conv_tail (B, K-1, din+2N))."""
    B, S, d = x.shape
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    Q = chunk_len(S, cfg.ssm_chunk)
    nC = S // Q

    proj = x @ params["w_in"]
    z, xin, Bc, Cc, dtp = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    K = params["conv"].shape[0]
    pad = conv_in.new_zeros((B, max(0, K - 1 - S), conv_in.shape[-1]))
    conv_tail = torch.cat([pad, conv_in[:, -(K - 1):]], dim=1)
    conv_out = _causal_conv(conv_in, params["conv"],
                            bias=params.get("conv_bias"))
    din = xin.shape[-1]
    xin, Bc, Cc = torch.split(conv_out, [din, N, N], dim=-1)

    dt = F.softplus(dtp.float() + params["dt_bias"])         # (B, S, H)
    A = -torch.exp(params["a_log"])                          # (H,)
    log_a = (dt * A).reshape(B, nC, Q, H)                    # decay per step
    xh = xin.reshape(B, nC, Q, H, P).float()
    dth = dt.reshape(B, nC, Q, H)
    Bh = Bc.reshape(B, nC, Q, N).float()
    Ch = Cc.reshape(B, nC, Q, N).float()

    # ---- intra-chunk (quadratic within Q, fp32) ----
    Lmat = torch.exp(_segsum(log_a.permute(0, 1, 3, 2)))     # (B,nC,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Ch, Bh)         # (B,nC,Q,Q)
    M = scores[:, :, None] * Lmat                            # (B,nC,H,Q,Q)
    M = M * dth.permute(0, 1, 3, 2)[:, :, :, None, :]        # weight by dt_j
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xh)

    # ---- chunk states ----
    cums = torch.cumsum(log_a, dim=2)                        # (B,nC,Q,H)
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)      # prod_{k>j} a_k
    state_c = torch.einsum("bcqn,bcqhp->bchnp", Bh,
                           (dth * decay_to_end)[..., None] * xh)
    chunk_decay = torch.exp(cums[:, :, -1, :])               # (B,nC,H)

    # ---- inter-chunk recurrence over chunk states ----
    h = initial_state.float() if initial_state is not None \
        else x.new_zeros((B, H, N, P), dtype=torch.float32)
    h_prevs = []
    for c in range(nC):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + state_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nC,H,N,P)

    decay_in = torch.exp(cums)                               # prod_{k<=q} a_k
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Ch, h_prevs) \
        * decay_in[..., None]

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + params["d_skip"][None, None, :, None] * xh.reshape(B, S, H, P)
    y = y.reshape(B, S, H * P).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm"], cfg.rms_eps)
    SSD_CALLS["prefill"] += 1
    return y @ params["w_out"], h, conv_tail


def ssd_decode_step(params: dict, x: torch.Tensor, cfg,
                    state: torch.Tensor, conv_state: torch.Tensor):
    """x: (B, 1, d); state: (B, H, N, P); conv_state: (B, K-1, din+2N).
    Returns (y (B, 1, d), state', conv_state'), new tensors."""
    B = x.shape[0]
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    proj = x @ params["w_in"]
    z, xin, Bc, Cc, dtp = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv"], conv_state,
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
    y = y.reshape(B, 1, H * P).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm"], cfg.rms_eps)
    SSD_CALLS["decode"] += 1
    return y @ params["w_out"], state, conv_state

"""Blockwise (flash-style) attention in plain torch: the port's
``attn_impl="flash"`` and the oracle for the Hopper kernel.

Counterpart of the JAX package's models/attention_flash.py, with its two
iteration schemes and its rounding order (fp32 scores and running state,
probabilities cast to v's dtype before the P.V product):

* full rectangle (causal / bidirectional / prefix): every q block visits
  every kv block, the mask applied per block;
* windowed (SWA / local attention): each q block visits one kv slice
  [start, start + span) of static size.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _block_mask(qi0, ki0, bq, bk, *, causal: bool, window: int, prefix: int,
                device) -> torch.Tensor:
    """Additive fp32 mask for a (bq, bk) block at global offsets."""
    qi = qi0 + torch.arange(bq, device=device)[:, None]
    ki = ki0 + torch.arange(bk, device=device)[None, :]
    allow = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        allow &= ki <= qi
    if window:
        allow &= (qi - ki) < window
    if prefix:
        allow |= ki < prefix
    return torch.where(allow, 0.0, NEG).to(torch.float32)


def _scores(q, k, mask, scale=None):
    """q: (B,Hkv,G,bq,D), k: (B,Hkv,bk,D) -> fp32 (B,Hkv,G,bq,bk); divided
    by sqrt(D), or times ``scale`` where one is given."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float())
    s = s / math.sqrt(q.shape[-1]) if scale is None else s * scale
    return s + mask


def _pv(p, v):
    return torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v).float()


def blockwise_attention(q, k, v, n_kv: int, *, causal: bool = True,
                        window: int = 0, prefix: int = 0, bq: int = 256,
                        bk: int = 512, scale: float | None = None) \
        -> torch.Tensor:
    """q: (B,S,Hq,D); k, v: (B,Sk,Hkv,D) -> (B,S,Hq,D).  fp32 accumulators;
    ``scale`` the softmax scale, None for 1/sqrt(D)."""
    B, S, Hq, D = q.shape
    Sk = k.shape[1]
    bq = min(bq, S)
    bk = min(bk, Sk)
    if S % bq or Sk % bk:      # smoke shapes: fall back to single block
        bq, bk = S, Sk
    G = Hq // n_kv
    nq, nk = S // bq, Sk // bk
    dev = q.device

    qg = q.reshape(B, S, n_kv, G, D).permute(0, 2, 3, 1, 4)   # (B,Hkv,G,S,D)
    kh = k.permute(0, 2, 1, 3)                                 # (B,Hkv,Sk,D)
    vh = v.permute(0, 2, 1, 3)
    use_window = bool(window) and Sk > (window + bq)

    outs = []
    for qi in range(nq):
        qblk = qg[:, :, :, qi * bq:(qi + 1) * bq]
        if use_window:
            span = -(-(window + bq) // bk) * bk
            start = min(max(qi * bq + bq - span, 0), Sk - span)
            ksl = kh[:, :, start:start + span]
            vsl = vh[:, :, start:start + span]
            mask = _block_mask(qi * bq, start, bq, span, causal=causal,
                               window=window, prefix=prefix, device=dev)
            s = _scores(qblk, ksl, mask, scale)
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            l = p.sum(dim=-1)
            acc = _pv(p, vsl)
        else:
            m = torch.full((B, n_kv, G, bq), NEG, dtype=torch.float32,
                           device=dev)
            l = torch.zeros((B, n_kv, G, bq), dtype=torch.float32, device=dev)
            acc = torch.zeros((B, n_kv, G, bq, D), dtype=torch.float32,
                              device=dev)
            for kj in range(nk):
                kblk = kh[:, :, kj * bk:(kj + 1) * bk]
                vblk = vh[:, :, kj * bk:(kj + 1) * bk]
                mask = _block_mask(qi * bq, kj * bk, bq, bk, causal=causal,
                                   window=window, prefix=prefix, device=dev)
                s = _scores(qblk, kblk, mask, scale)
                m_new = torch.maximum(m, s.amax(dim=-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + _pv(p, vblk)
                m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3)                               # (B,Hkv,G,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)

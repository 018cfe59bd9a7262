"""Flash attention with a hand-written backward in plain torch: the port's
``attn_impl="flash_cvjp"``.

Counterpart of the JAX package's models/attention_flash_vjp.py, a
``torch.autograd.Function`` where that one is a ``custom_vjp`` (there is no
Pallas kernel in it).  The forward visits every (q block, kv block) pair
with an online softmax and saves only (q, k, v, out, lse); the backward
recomputes each score block, kv-inner inside a q-outer loop, with the
reference's roundings: fp32 scores and accumulators, p cast to v's dtype
before dv, ds cast to q's dtype before dq and dk.
"""
from __future__ import annotations

import math

import torch

from .attention_flash import NEG, _block_mask


def _blocks(S, Sk, bq, bk):
    bq, bk = min(bq, S), min(bk, Sk)
    if S % bq or Sk % bk:      # smoke shapes: fall back to single block
        bq, bk = S, Sk
    return bq, bk


def _heads(x, n_kv):
    """(B, S, H, D) -> (B, n_kv, G, S, D); k/v pass n_kv = H, G = 1."""
    B, S, H, D = x.shape
    return x.reshape(B, S, n_kv, H // n_kv, D).permute(0, 2, 3, 1, 4)


def _forward(q, k, v, n_kv, causal, window, prefix, bq, bk):
    B, S, Hq, D = q.shape
    Sk = k.shape[1]
    bq, bk = _blocks(S, Sk, bq, bk)
    G = Hq // n_kv
    dev = q.device
    qg = _heads(q, n_kv)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    outs, lses = [], []
    for qi in range(S // bq):
        qblk = qg[:, :, :, qi * bq:(qi + 1) * bq]
        m = torch.full((B, n_kv, G, bq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, n_kv, G, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, n_kv, G, bq, D), dtype=torch.float32,
                          device=dev)
        for kj in range(Sk // bk):
            kblk = kh[:, :, kj * bk:(kj + 1) * bk]
            vblk = vh[:, :, kj * bk:(kj + 1) * bk]
            mask = _block_mask(qi * bq, kj * bk, bq, bk, causal=causal,
                               window=window, prefix=prefix, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk.float(),
                             kblk.float()) / math.sqrt(D) + mask
            m_new = torch.maximum(m, s.amax(dim=-1))
            scale = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * scale + p.sum(dim=-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vblk.dtype), vblk).float()
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        outs.append((acc / lc[..., None]).to(q.dtype))
        lses.append(m + torch.log(lc))
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)
    return out, torch.cat(lses, dim=3), (bq, bk)


def _backward(q, k, v, out, lse, dout, n_kv, causal, window, prefix, bq, bk):
    B, S, Hq, D = q.shape
    Sk = k.shape[1]
    G = Hq // n_kv
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qg, dog, og = _heads(q, n_kv), _heads(dout, n_kv), _heads(out, n_kv)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    delta = (dog.float() * og.float()).sum(dim=-1)          # (B,h,G,S)
    nk = Sk // bk
    dk_acc = torch.zeros((nk, B, n_kv, bk, D), dtype=torch.float32,
                         device=dev)
    dv_acc = torch.zeros_like(dk_acc)
    dqs = []
    for qi in range(S // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        qblk, doblk = qg[:, :, :, rows], dog[:, :, :, rows]
        lse_q, delta_q = lse[..., rows], delta[..., rows]
        dq_acc = torch.zeros((B, n_kv, G, bq, D), dtype=torch.float32,
                             device=dev)
        for kj in range(nk):
            kblk = kh[:, :, kj * bk:(kj + 1) * bk]
            vblk = vh[:, :, kj * bk:(kj + 1) * bk]
            mask = _block_mask(qi * bq, kj * bk, bq, bk, causal=causal,
                               window=window, prefix=prefix, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk.float(),
                             kblk.float()) * scale + mask
            p = torch.exp(s - lse_q[..., None])
            dv_blk = torch.einsum("bhgqk,bhgqd->bhkd", p.to(v.dtype), doblk)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doblk.float(),
                              vblk.float())
            ds = p * (dp - delta_q[..., None]) * scale
            dsb = ds.to(q.dtype)
            dq_acc = dq_acc + torch.einsum("bhgqk,bhkd->bhgqd", dsb,
                                           kblk).float()
            dk_acc[kj] += torch.einsum("bhgqk,bhgqd->bhkd", dsb, qblk).float()
            dv_acc[kj] += dv_blk.float()
        dqs.append(dq_acc)
    dq = torch.cat(dqs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)
    dk = dk_acc.permute(1, 0, 3, 2, 4).reshape(B, Sk, n_kv, D)
    dv = dv_acc.permute(1, 0, 3, 2, 4).reshape(B, Sk, n_kv, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashCVJP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, n_kv, causal, window, prefix, bq, bk):
        out, lse, blocks = _forward(q, k, v, n_kv, causal, window, prefix,
                                    bq, bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (n_kv, causal, window, prefix, *blocks)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(),
                               *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, n_kv: int, causal: bool = True, window: int = 0,
                    prefix: int = 0, bq: int = 256, bk: int = 512):
    """q: (B, S, Hq, D); k, v: (B, Sk, n_kv, D) -> (B, S, Hq, D)."""
    return _FlashCVJP.apply(q, k, v, n_kv, causal, window, prefix, bq, bk)

"""The plain attention mathematics that the model layers and the kernels'
plain twins share: rotary embeddings and grouped-query softmax attention.

It imports nothing of the port, so ``models.layers`` (which re-exports it)
and ``kernels.decode_attention`` (whose twin is built from it) both depend
on it, and neither on the other's internals.  The rounding order at each
step is the JAX package's (``repro.models.layers``).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rope_freqs(head_dim: int, pct: float, theta: float):
    """Inverse frequencies as numpy float32 (as the JAX package computes
    them), or None when nothing rotates."""
    rot = int(head_dim * pct) // 2 * 2
    if rot == 0:
        return None
    return 1.0 / (theta ** (np.arange(0, rot, 2, np.float32) / rot))


def rope(x: torch.Tensor, positions: torch.Tensor, pct: float,
         theta: float, bf16: bool) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer. Rotates the first
    pct*D dims pairwise (half-split convention).  ``bf16``: cos, sin and
    the rotation's products in x's dtype; else in fp32, rounded once."""
    D = x.shape[-1]
    inv = rope_freqs(D, pct, theta)
    if inv is None:
        return x
    rot = inv.shape[0] * 2
    inv = torch.from_numpy(inv).to(x.device)
    ang = positions[..., :, None].float() * inv          # (..., S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]                # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    if bf16:
        cos = cos.to(x.dtype)
        sin = sin.to(x.dtype)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, xp],
                         dim=-1)
    y1 = x1.float() * cos - x2.float() * sin
    y2 = x2.float() * cos + x1.float() * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], dim=-1)


def gqa_scores_softmax_v(q, k, v, mask, n_kv, scale=None):
    """q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D). Returns (B,Sq,Hq,D).
    Scores in fp32, divided by sqrt(D) after the product (times ``scale``
    where one is given); probabilities cast to q's dtype before the P.V
    product."""
    B, Sq, Hq, D = q.shape
    G = Hq // n_kv
    qg = q.reshape(B, Sq, n_kv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(D) if scale is None else scores * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, D)

"""Shared model layers in torch: norms, rotary embeddings, attention (GQA/MQA,
causal / sliding-window / prefix-LM masks, ring KV caches), MLPs.

Counterpart of the JAX package's models/layers.py, with the same rounding
order at each step.  Params are plain dicts of tensors with the JAX
pytree's keys and shapes; ``init_*`` draws them from an explicit
``torch.Generator`` on its device (with none, makes them on the meta
device, drawing nothing).  There is no mesh here, so
``shard_batch``/``shard_expert`` are identities.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

Params = dict


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    return x


def shard_expert(x: torch.Tensor, expert_dim: int = 1,
                 n_experts: int = 0) -> torch.Tensor:
    return x


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def init_device(gen: torch.Generator | None) -> torch.device:
    """Where ``init_*`` puts its leaves: on the generator's device, or on
    the meta device where there is no generator (shapes only, no draw)."""
    return torch.device("meta") if gen is None else gen.device


def _init(gen: torch.Generator | None, shape, scale=None,
          dtype=torch.float32):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * float(scale)).to(dtype)


# --------------------------- norms ---------------------------

_NORM_BF16 = False  # bf16 norm/rope products (fp32 variance only)


def set_norm_bf16(flag: bool) -> None:
    global _NORM_BF16
    _NORM_BF16 = flag


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    if _NORM_BF16:
        # products in x's dtype, the mean of squares accumulated in fp32
        var = x.square().float().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * w.to(x.dtype)
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# --------------------------- rotary ---------------------------

def rope_freqs(head_dim: int, pct: float, theta: float):
    """Inverse frequencies as numpy float32 (as the JAX package computes
    them), or None when nothing rotates."""
    rot = int(head_dim * pct) // 2 * 2
    if rot == 0:
        return None
    return 1.0 / (theta ** (np.arange(0, rot, 2, np.float32) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, pct: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer. Rotates the first
    pct*D dims pairwise (half-split convention)."""
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
    if _NORM_BF16:
        cos = cos.to(x.dtype)
        sin = sin.to(x.dtype)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, xp],
                         dim=-1)
    y1 = x1.float() * cos - x2.float() * sin
    y2 = x2.float() * cos + x1.float() * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], dim=-1)


# --------------------------- masks ---------------------------

def causal_mask(S: int, window: int = 0, prefix: int = 0,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """(S, S) additive mask. window>0 => sliding window; prefix>0 => first
    `prefix` positions attend bidirectionally (prefix-LM)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    allow = j <= i
    if window:
        allow &= (i - j) < window
    if prefix:
        allow |= j < prefix
    return torch.where(allow, 0.0, -1e30).to(dtype)


# --------------------------- attention ---------------------------

def init_attention(gen: torch.Generator, cfg, tp_pad: int = 1) -> Params:
    d = cfg.d_model
    hq = cfg.padded_heads(tp_pad)
    dt = _dtype(cfg)
    wq = _init(gen, (d, hq * cfg.head_dim), dtype=dt)
    if hq != cfg.n_heads:  # zero the pad heads: exact math
        wq[:, cfg.n_heads * cfg.head_dim:] = 0
    wk = _init(gen, (d, cfg.kv_dim), dtype=dt)
    wv = _init(gen, (d, cfg.kv_dim), dtype=dt)
    wo = _init(gen, (hq * cfg.head_dim, d), dtype=dt)
    if hq != cfg.n_heads:
        wo[cfg.n_heads * cfg.head_dim:, :] = 0
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def _split_heads(x, n_heads, head_dim):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def gqa_scores_softmax_v(q, k, v, mask, n_kv):
    """q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D). Returns (B,Sq,Hq,D).
    Scores in fp32, divided by sqrt(D) after the product; probabilities
    cast to q's dtype before the P.V product."""
    B, Sq, Hq, D = q.shape
    G = Hq // n_kv
    qg = q.reshape(B, Sq, n_kv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, D)


def attention_decode(params: Params, x: torch.Tensor, cfg,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     n_heads: int):
    """One-token decode against a (B, S_cache, Hkv, D) ring cache.
    pos: current position (an int, the same for every row).
    Returns (out (B,1,d), cache_k, cache_v).

    Unlike the JAX function, the new k/v are written into ``cache_k`` and
    ``cache_v`` in place (slot ``pos % S_cache``): at full width a copy
    would move the whole cache every step.  The caches are still returned,
    so the API matches."""
    B, one, d = x.shape
    S_cache = cache_k.shape[1]
    q = _split_heads(x @ params["wq"], n_heads, cfg.head_dim)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, cfg.head_dim)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rotary_pct, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rotary_pct, cfg.rope_theta)
    slot = pos % S_cache
    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)
    # Ring buffer: slots beyond `pos` are unwritten until the buffer wraps
    # (SWA archs allocate cache_len == window, so wrapping IS the sliding
    # window; RoPE is baked into cached k, and softmax is
    # permutation-invariant over slots, so ring order is harmless).
    idx = torch.arange(S_cache, device=x.device)
    valid = (idx <= pos) | (pos >= S_cache)
    mask = torch.where(valid, 0.0, -1e30).to(torch.float32)[None, None, None]
    out = gqa_scores_softmax_v(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                               mask, cfg.n_kv_heads)
    return out.reshape(B, 1, -1) @ params["wo"], cache_k, cache_v


# --------------------------- MLPs ---------------------------

def init_mlp(gen: torch.Generator, cfg, d_ff: int | None = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": _init(gen, (d, ff), dtype=dt),
                "w_up": _init(gen, (d, ff), dtype=dt),
                "w_down": _init(gen, (ff, d), dtype=dt)}
    return {"w_in": _init(gen, (d, ff), dtype=dt),
            "w_out": _init(gen, (ff, d), dtype=dt)}


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if "w_gate" in params:
        act = F.silu if cfg.mlp == "swiglu" else _gelu
        return (act(x @ params["w_gate"]) * (x @ params["w_up"])) \
            @ params["w_down"]
    return _gelu(x @ params["w_in"]) @ params["w_out"]


# --------------------------- embeddings / head ---------------------------

def init_embedding(gen: torch.Generator, cfg) -> Params:
    V = cfg.padded_vocab()
    dt = _dtype(cfg)
    return {"tok": _init(gen, (V, cfg.d_model), scale=0.02, dtype=dt),
            "head": _init(gen, (cfg.d_model, V), dtype=dt),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt,
                                     device=init_device(gen))}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def lm_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return x @ params["head"]

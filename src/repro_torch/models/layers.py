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

import numpy as np
import torch
import torch.nn.functional as F

# rope_freqs and gqa_scores_softmax_v are this module's names too, as in the
# JAX package; they live below both the layers and the kernels' twins
from ..kernels.attention_math import (gqa_scores_softmax_v, rope,
                                      rope_freqs)
from ..kernels.decode_attention import decode_attn_op
from ..spans import span

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

def apply_rope(x: torch.Tensor, positions: torch.Tensor, pct: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer. Rotates the first
    pct*D dims pairwise (half-split convention), in bf16 products where
    ``set_norm_bf16`` is on (``kernels.attention_math.rope``)."""
    return rope(x, positions, pct, theta, _NORM_BF16)


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


def softmax_scale(cfg) -> float | None:
    """The configuration's softmax scale, or None for 1/sqrt(head_dim)."""
    return cfg.attention_multiplier or None


def attention_decode(params: Params, x: torch.Tensor, cfg,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     n_heads: int):
    """One-token decode against a (B, S_cache, Hkv, D) ring cache.
    pos: current position (an int, the same for every row).
    Returns (out (B,1,d), cache_k, cache_v).

    Unlike the JAX function, the new k/v are written into ``cache_k`` and
    ``cache_v`` in place (slot ``pos % S_cache``): at full width a copy
    would move the whole cache every step.  The caches are still returned,
    so the API matches.  Everything after the projections (rope, the slot
    write, the attention over the valid slots) is one custom op,
    ``repro_torch::decode_attn``: a kernel on the card, its plain twin
    (``kernels.decode_attention.decode_attention_reference``) on the
    CPU."""
    with span("decode.attention"):
        B = x.shape[0]
        q = _split_heads(x @ params["wq"], n_heads, cfg.head_dim)
        k = _split_heads(x @ params["wk"], cfg.n_kv_heads, cfg.head_dim)
        v = _split_heads(x @ params["wv"], cfg.n_kv_heads, cfg.head_dim)
        out = decode_attn_op(q, k, v, cache_k, cache_v, pos,
                             cfg.rotary_pct, cfg.rope_theta, _NORM_BF16,
                             softmax_scale(cfg))
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
    """The token embedding, the head (none where ``tie_embeddings``: the
    head is then the embedding's transpose) and the final norm."""
    V = cfg.padded_vocab()
    dt = _dtype(cfg)
    p = {"tok": _init(gen, (V, cfg.d_model), scale=0.02, dtype=dt)}
    if not cfg.tie_embeddings:
        p["head"] = _init(gen, (cfg.d_model, V), dtype=dt)
    p["final_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                 device=init_device(gen))
    return p


def embed(params: Params, tokens: torch.Tensor,
          multiplier: float = 1.0) -> torch.Tensor:
    x = params["tok"][tokens]
    return x * multiplier if multiplier != 1.0 else x


def lm_logits(params: Params, x: torch.Tensor, cfg=None) -> torch.Tensor:
    """The final norm and the head: ``params["head"]``, or where there is
    none (a tied head) the embedding's transpose, no copy.  With a
    ``cfg``, its norm eps and its ``logits_scaling``."""
    x = rms_norm(x, params["final_norm"], 1e-6 if cfg is None
                 else cfg.rms_eps)
    logits = x @ (params["head"] if "head" in params else params["tok"].t())
    if cfg is not None and cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits

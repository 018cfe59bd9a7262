"""Serving paths in torch, dense family: prefill (build the KV cache over a
full prompt) and decode (one token against the cache).

Counterpart of the JAX package's models/decode.py.  Caches are dicts of
layer-stacked (L, B, S_cache, Hkv, D) tensors.  SWA architectures allocate
ring caches of window length, so decoding costs O(window) per step.
Decode writes the new k/v into the cache in place (see
``layers.attention_decode``) and returns the same dict.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import layers as L
from . import transformer as T

Params = dict


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor that is not allocated."""
    shape: tuple
    dtype: torch.dtype


def cache_len(cfg, seq_len: int) -> int:
    if cfg.swa_window:
        return min(seq_len, cfg.swa_window)
    return seq_len


def cache_spec(cfg, seq_len: int, batch: int) -> dict:
    """TensorSpec dict of the decode cache."""
    T._require_ported(cfg)
    Lc = cache_len(cfg, seq_len)
    shape = (cfg.n_layers, batch, Lc, cfg.n_kv_heads, cfg.head_dim)
    dt = L._dtype(cfg)
    return {"k": TensorSpec(shape, dt), "v": TensorSpec(shape, dt)}


def init_cache(cfg, seq_len: int, batch: int, device=None) -> dict:
    device = resolve_device(device)
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in cache_spec(cfg, seq_len, batch).items()}


# ======================================================================
# decode: one token
# ======================================================================

def forward_decode(params: Params, cfg, cache: dict, tokens: torch.Tensor,
                   pos):
    """tokens: (B, 1) integer; pos: the current position (int or 0-d
    tensor, the same for every row).  Returns (hidden (B, 1, d), cache),
    the cache updated in place."""
    T._require_ported(cfg)
    pos = int(pos)
    n_heads = T.params_n_heads(params, cfg)
    x = L.embed(params["embed"], tokens)
    if cfg.rotary_pct == 0.0:
        posv = torch.full((x.shape[0], 1), pos, device=x.device)
        x = x + T._sinusoidal(posv, cfg.d_model).to(x.dtype)
    for i in range(cfg.n_layers):
        lp = T.layer(params["blocks"], i)
        h = L.rms_norm(x, lp["norm1"])
        out, _, _ = L.attention_decode(lp["attn"], h, cfg, cache["k"][i],
                                       cache["v"][i], pos, n_heads)
        x = x + out
        x, _ = T._apply_mlp_or_moe(lp, x, cfg)
    return x, cache


# ======================================================================
# prefill: full prompt -> cache
# ======================================================================

def _fit_cache_seq(k: torch.Tensor, target: int) -> torch.Tensor:
    """k: (L, B, S', H, D). Keep the last `target` positions / zero-pad up
    to `target` slots (slot i == position i, so decode's ring write at
    pos >= S' lands in the padded region)."""
    S_ = k.shape[2]
    if target == S_:
        return k
    if target < S_:
        return k[:, :, -target:]
    pad = torch.zeros((*k.shape[:2], target - S_, *k.shape[3:]),
                      dtype=k.dtype, device=k.device)
    return torch.cat([k, pad], dim=2)


def forward_prefill(params: Params, cfg, batch, pad_to: int | None = None):
    """-> (hidden (B, S, d), cache). Builds the serving cache; `pad_to`
    sizes the KV cache for subsequent decode steps (defaults to the
    prompt length + 1)."""
    T._require_ported(cfg)
    n_heads = T.params_n_heads(params, cfg)
    x, positions = T._embed_inputs(params, cfg, batch)
    pad_to = pad_to if pad_to is not None else x.shape[1] + 1
    Lc = cache_len(cfg, max(x.shape[1], pad_to))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, _, (k, v) = T._dense_block(T.layer(params["blocks"], i), x, cfg,
                                      positions, n_heads=n_heads,
                                      window=cfg.swa_window, prefix=0,
                                      collect_kv=True)
        ks.append(_fit_cache_seq(k[None], Lc)[0])
        vs.append(_fit_cache_seq(v[None], Lc)[0])
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}

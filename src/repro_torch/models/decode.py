"""Serving paths in torch: prefill (build the cache over a full prompt)
and decode (one token against the cache), for every family.

Counterpart of the JAX package's models/decode.py.  Caches are dicts of
layer-stacked tensors: (L, B, S_cache, Hkv, D) k/v for attention layers
(SWA and the hybrid's local attention allocate ring caches of window
length, so decoding costs O(window) per step), the SSM's fp32 (L, B, H, N,
P) state and conv tail, the hybrid's fp32 (n_rec, B, w) RG-LRU state and
conv tail beside its local k/v, the encoder-decoder's self-attention k/v
beside its cross-attention ``xk``/``xv`` over the encoder's output (which
decode reads and never writes).  The VLM's cache is the dense one over the
prefix and the text.  Decode writes the new k/v, states and
conv tails into the cache in place (see ``layers.attention_decode``) and
returns the same dict.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import layers as L
from . import rglru as R
from . import ssm as SSM
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
    dt = L._dtype(cfg)
    if cfg.family == "ssm":
        din = cfg.ssm_expand * cfg.d_model
        return {
            "state": TensorSpec((cfg.n_layers, batch, cfg.ssm_heads,
                                 cfg.ssm_state, cfg.ssm_headdim),
                                torch.float32),
            "conv": TensorSpec((cfg.n_layers, batch, cfg.conv_width - 1,
                                din + 2 * cfg.ssm_state), dt)}
    if cfg.family == "hybrid":
        n_super, n_left = T.hybrid_layout(cfg)
        n_rec = 2 * n_super + n_left
        w = cfg.lru_width or cfg.d_model
        kv = (n_super, batch, min(seq_len, cfg.local_window), cfg.n_kv_heads,
              cfg.head_dim)
        return {"rec_h": TensorSpec((n_rec, batch, w), torch.float32),
                "rec_conv": TensorSpec((n_rec, batch, cfg.conv_width - 1, w),
                                       dt),
                "k": TensorSpec(kv, dt), "v": TensorSpec(kv, dt)}
    if cfg.family == "encdec":
        # the reference's split: Se = S // 2 frames, Sd = S - Se tokens
        # (input_specs gives the tokens S // 2; both as in the reference)
        Se = seq_len // 2
        Sd = seq_len - Se
        kv = lambda n: TensorSpec((cfg.dec_layers, batch, n, cfg.n_kv_heads,
                                   cfg.head_dim), dt)
        return {"k": kv(Sd), "v": kv(Sd), "xk": kv(Se), "xv": kv(Se)}
    shape = (cfg.n_layers, batch, cache_len(cfg, seq_len), cfg.n_kv_heads,
             cfg.head_dim)
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
    pos = int(pos)
    n_heads = T.params_n_heads(params, cfg)
    x = L.embed(params["embed"], tokens)
    if cfg.rotary_pct == 0.0 and cfg.family != "ssm":
        posv = torch.full((x.shape[0], 1), pos, device=x.device)
        x = x + T._sinusoidal(posv, cfg.d_model).to(x.dtype)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            lp = T.layer(params["blocks"], i)
            h = L.rms_norm(x, lp["norm1"])
            y, st, cv = SSM.ssd_decode_step(lp["ssm"], h, cfg,
                                            cache["state"][i],
                                            cache["conv"][i])
            cache["state"][i].copy_(st)
            cache["conv"][i].copy_(cv)
            x = x + y
        return x, cache
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, cache, x, pos, n_heads), cache
    if cfg.family == "encdec":
        return _encdec_decode(params, cfg, cache, x, pos, n_heads), cache
    for i in range(cfg.n_layers):
        lp = T.layer(params["blocks"], i)
        x = _attn_decode_block(lp, x, cfg, cache, i, pos, n_heads)
    return x, cache


def _attn_decode_block(lp, x, cfg, cache, i, pos, n_heads):
    """One attention block's decode step against cache k/v ``i``."""
    h = L.rms_norm(x, lp["norm1"])
    out, _, _ = L.attention_decode(lp["attn"], h, cfg, cache["k"][i],
                                   cache["v"][i], pos, n_heads)
    x, _ = T._apply_mlp_or_moe(lp, x + out, cfg)
    return x


def _rec_decode_block(lp, x, cfg, cache, j):
    """Rec layer ``j``'s decode step; its state and conv tail in place."""
    h = L.rms_norm(x, lp["norm1"])
    y, hf, cf = R.rglru_decode_step(lp["rec"], h, cfg, cache["rec_h"][j],
                                    cache["rec_conv"][j])
    cache["rec_h"][j].copy_(hf)
    cache["rec_conv"][j].copy_(cf)
    x, _ = T._apply_mlp_or_moe(lp, x + y, cfg)
    return x


def _hybrid_decode(params, cfg, cache, x, pos, n_heads):
    """The hybrid's layers in ``forward_train``'s order (see
    ``transformer.hybrid_layout``)."""
    n_super, n_left = T.hybrid_layout(cfg)
    rec, attn = params["rec_blocks"], params["attn_blocks"]
    for s in range(n_super):
        for j in (s, n_super + s):
            x = _rec_decode_block(T.layer(rec, j), x, cfg, cache, j)
        x = _attn_decode_block(T.layer(attn, s), x, cfg, cache, s, pos,
                               n_heads)
    for j in range(2 * n_super, 2 * n_super + n_left):
        x = _rec_decode_block(T.layer(rec, j), x, cfg, cache, j)
    return x


def _encdec_decode(params, cfg, cache, x, pos, n_heads):
    """The decoder's layers: self-attention against the ring cache, then
    cross-attention against the cached encoder k/v (the reference's plain
    softmax, no mask), then the MLP."""
    for i in range(cfg.dec_layers):
        lp = T.layer(params["decoder"], i)
        h = L.rms_norm(x, lp["norm1"])
        out, _, _ = L.attention_decode(lp["attn"], h, cfg, cache["k"][i],
                                       cache["v"][i], pos, n_heads)
        x = x + out
        h = L.rms_norm(x, lp["norm3"])
        q = L._split_heads(h @ lp["xattn"]["wq"], n_heads, cfg.head_dim)
        out = L.gqa_scores_softmax_v(q, cache["xk"][i].to(q.dtype),
                                     cache["xv"][i].to(q.dtype), None,
                                     cfg.n_kv_heads)
        x = x + out.reshape(*x.shape[:2], -1) @ lp["xattn"]["wo"]
        x, _ = T._apply_mlp_or_moe(lp, x, cfg)
    return x


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
    n_heads = T.params_n_heads(params, cfg)
    x, positions = T._embed_inputs(params, cfg, batch)
    pad_to = pad_to if pad_to is not None else x.shape[1] + 1
    if cfg.family == "encdec":
        return _encdec_prefill(params, cfg, batch["src_emb"], x, positions,
                               n_heads, pad_to)
    if cfg.family == "ssm":
        states, convs = [], []
        for i in range(cfg.n_layers):
            x, (st, cv) = T._ssm_block(T.layer(params["blocks"], i), x, cfg)
            states.append(st)
            convs.append(cv)
        return x, {"state": torch.stack(states), "conv": torch.stack(convs)}
    if cfg.family == "hybrid":
        return _hybrid_prefill(params, cfg, x, positions, n_heads, pad_to)
    Lc = cache_len(cfg, max(x.shape[1], pad_to))
    prefix = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, _, (k, v) = T._dense_block(T.layer(params["blocks"], i), x, cfg,
                                      positions, n_heads=n_heads,
                                      window=cfg.swa_window, prefix=prefix,
                                      collect_kv=True)
        ks.append(_fit_cache_seq(k[None], Lc)[0])
        vs.append(_fit_cache_seq(v[None], Lc)[0])
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def _hybrid_prefill(params, cfg, x, positions, n_heads, pad_to):
    """The local caches keep the last ``Wloc`` positions in slots 0.. as
    the reference's do, so a prompt longer than the window leaves decode
    evicting the wrong slot (the SWA ring-cache fault, reproduced)."""
    n_super, n_left = T.hybrid_layout(cfg)
    rec, attn = params["rec_blocks"], params["attn_blocks"]
    Wloc = min(max(x.shape[1], pad_to), cfg.local_window)
    hs = [None] * (2 * n_super + n_left)
    cs = [None] * len(hs)
    ks, vs = [], []
    for s in range(n_super):
        for j in (s, n_super + s):
            x, hs[j], cs[j] = T._rec_block(T.layer(rec, j), x, cfg)
        x, _, (k, v) = T._dense_block(T.layer(attn, s), x, cfg, positions,
                                      n_heads=n_heads,
                                      window=cfg.local_window, prefix=0,
                                      collect_kv=True)
        ks.append(_fit_cache_seq(k[None], Wloc)[0])
        vs.append(_fit_cache_seq(v[None], Wloc)[0])
    for j in range(2 * n_super, len(hs)):
        x, hs[j], cs[j] = T._rec_block(T.layer(rec, j), x, cfg)
    return x, {"rec_h": torch.stack(hs), "rec_conv": torch.stack(cs),
               "k": torch.stack(ks), "v": torch.stack(vs)}


def _encdec_prefill(params, cfg, src_emb, x, positions, n_heads, pad_to):
    """The encoder over the frames, then the decoder over the tokens ``x``;
    the self-attention cache fitted to ``pad_to`` slots, the cross cache
    kept at the encoder's length."""
    enc_x, enc_pos = T._encoder_input(cfg, src_emb)
    for i in range(cfg.enc_layers):
        enc_x, _ = T._enc_block(T.layer(params["encoder"], i), enc_x, cfg,
                                enc_pos, n_heads=n_heads)
    ks, vs, xks, xvs = [], [], [], []
    for i in range(cfg.dec_layers):
        x, _, ((k, v), (xk, xv)) = T._cross_block(
            T.layer(params["decoder"], i), x, enc_x, cfg, positions,
            n_heads=n_heads, collect_kv=True)
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    return x, {"k": _fit_cache_seq(torch.stack(ks), pad_to),
               "v": _fit_cache_seq(torch.stack(vs), pad_to),
               "xk": torch.stack(xks), "xv": torch.stack(xvs)}

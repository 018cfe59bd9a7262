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
prefix and the text.  The ssm_moe family (granite-4.0-h) keeps both kinds
side by side: the Mamba2 layers' fp32 ``state`` and ``conv`` tails
stacked over ``ssm_blocks``, the attention layers' ``k``/``v`` over
``attn_blocks``, each indexed by its own stack as ``layer_order`` walks the
layers.  Decode writes the new k/v, states and
conv tails into the cache in place (see ``layers.attention_decode``) and
returns the same dict.

On the card an ssm_moe decode step replays CUDA graphs where it can
(``DecodeGraphs``): one graph for each Mamba2 mixer and each MoE FFN,
chained through static buffers, replayed inside its span; only the
attention mixers (their ``decode_attn`` call takes the position), the
embedding and the head run op by op.  A decode step otherwise launches
some 3,500 kernels, and the host, not the card, would set its pace.  The
graphs are captured after the first step on a cache (which runs op by
op) and serve every later step on that cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..spans import span
from ..tree import tree_leaves
from . import layers as L
from . import moe as M
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
    if cfg.family in ("ssm", "ssm_moe"):
        din = cfg.ssm_expand * cfg.d_model
        n_attn = cfg.layer_types.count("attention")
        n_ssm = cfg.n_layers - n_attn
        out = {
            "state": TensorSpec((n_ssm, batch, cfg.ssm_heads, cfg.ssm_state,
                                 cfg.ssm_headdim), torch.float32),
            "conv": TensorSpec((n_ssm, batch, cfg.conv_width - 1,
                                din + 2 * cfg.ssm_state), dt)}
        if n_attn:
            kv = TensorSpec((n_attn, batch, cache_len(cfg, seq_len),
                             cfg.n_kv_heads, cfg.head_dim), dt)
            out.update(k=kv, v=kv)
        return out
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
                   pos, graphs: "DecodeGraphs | None" = None):
    """tokens: (B, 1) integer; pos: the current position (int or 0-d
    tensor, the same for every row).  Returns (hidden (B, 1, d), cache),
    the cache updated in place.  ``graphs``: an ssm_moe step's CUDA graphs
    (``DecodeGraphs``), kept by the caller from step to step."""
    pos = int(pos)
    n_heads = T.params_n_heads(params, cfg)
    x = L.embed(params["embed"], tokens, cfg.embedding_multiplier)
    if cfg.rotary_pct == 0.0 and cfg.family != "ssm" and not cfg.nope:
        posv = torch.full((x.shape[0], 1), pos, device=x.device)
        x = x + T._sinusoidal(posv, cfg.d_model).to(x.dtype)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_decode_block(T.layer(params["blocks"], i), x, cfg,
                                  cache, i)
        return x, cache
    if cfg.family == "ssm_moe":
        if graphs is not None and x.is_cuda:
            return graphs.run(params, cfg, cache, x, pos, n_heads), cache
        return _ssm_moe_decode(params, cfg, cache, x, pos, n_heads), cache
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, cache, x, pos, n_heads), cache
    if cfg.family == "encdec":
        return _encdec_decode(params, cfg, cache, x, pos, n_heads), cache
    for i in range(cfg.n_layers):
        lp = T.layer(params["blocks"], i)
        x = _attn_decode_block(lp, x, cfg, cache, i, pos, n_heads)
    return x, cache


def _ssm_decode_block(lp, x, cfg, cache, j):
    """Mamba2 layer ``j``'s decode mixer (norm, the recurrence step, the
    scaled residual), its state and conv tail written in place."""
    with span("decode.ssm"):
        h = L.rms_norm(x, lp["norm1"], cfg.rms_eps)
        y, st, cv = SSM.ssd_decode_step(lp["ssm"], h, cfg,
                                        cache["state"][j], cache["conv"][j])
        cache["state"][j].copy_(st)
        cache["conv"][j].copy_(cv)
        return T._residual(x, y, cfg)


def _ssm_moe_decode(params, cfg, cache, x, pos, n_heads):
    """granite-4.0-h's layers in ``layer_order``: each mixer against its
    own stack's cache, then the dropless MoE FFN."""
    for kind, j in T.layer_order(cfg):
        if kind == "mamba":
            lp = T.layer(params["ssm_blocks"], j)
            x = _ssm_decode_block(lp, x, cfg, cache, j)
        else:
            lp = T.layer(params["attn_blocks"], j)
            x = _attention_mixer(lp, x, cfg, cache, j, pos, n_heads)
        x = T._serve_ffn(lp, x, cfg, "decode.moe")
    return x


def _attention_mixer(lp, x, cfg, cache, j, pos, n_heads):
    """ssm_moe attention layer ``j``'s mixer against its ring cache."""
    h = L.rms_norm(x, lp["norm1"], cfg.rms_eps)
    out, _, _ = L.attention_decode(lp["attn"], h, cfg, cache["k"][j],
                                   cache["v"][j], pos, n_heads)
    return T._residual(x, out, cfg)


GRAPH_CAPTURES = 0     # DecodeGraphs captures, counted on the host


class DecodeGraphs:
    """CUDA graphs of an ssm_moe decode step on one cache and batch size
    (of at most ``moe.BATCHED_MAX_TOKENS`` rows, where the MoE takes its
    batched route; more rows run op by op):
    each Mamba2 mixer and each MoE FFN captured alone, in layer order, the
    output of one the static input of the next; an attention mixer runs op
    by op between them (its ``decode_attn`` takes the position), and the
    graph after it reads a copy of its output.  ``run`` replays each graph
    inside the span its ops would have opened, and counts its calls as
    they would have (``ssm.SSD_CALLS``, ``moe.DROPLESS_CALLS``).  The
    first step on a new cache or batch size runs op by op, and the graphs
    are captured after it: capturing runs nothing, so the cache advances
    once.  The graphs share one memory pool and replay in the order they
    were captured, as that requires.  ``run`` returns the last graph's
    static output, which the next step overwrites."""

    def __init__(self):
        self.key = None
        self.steps = []

    @staticmethod
    def _key(params, cache, x):
        """What the graphs read by address: the params, the cache and the
        batch size."""
        return (x.shape[0],) + tuple(t.data_ptr() for t in (
            *tree_leaves(params), *cache.values()))

    def run(self, params, cfg, cache, x, pos, n_heads):
        if x.shape[0] > M.BATCHED_MAX_TOKENS:
            # the grouped route sizes its groups on the host: no graph
            return _ssm_moe_decode(params, cfg, cache, x, pos, n_heads)
        if self.key != self._key(params, cache, x):
            out = _ssm_moe_decode(params, cfg, cache, x, pos, n_heads)
            self._capture(params, cfg, cache, x)
            return out
        for kind, j, lp, graph, inp, out in self.steps:
            if kind == "attention":
                x = _attention_mixer(lp, x, cfg, cache, j, pos, n_heads)
                continue
            if inp is not x:
                inp.copy_(x)
            with span("decode.ssm" if kind == "mamba" else "decode.moe"):
                graph.replay()
            if kind == "mamba":
                SSM.SSD_CALLS["decode"] += 1
            else:
                M.DROPLESS_CALLS["batched"] += 1
            x = out
        return x

    def _capture(self, params, cfg, cache, x):
        self.key, self.steps = None, []
        calls = (dict(SSM.SSD_CALLS), dict(M.DROPLESS_CALLS))
        pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize()
        prev = None

        def graphed(kind, j, lp, fn):
            nonlocal prev
            inp = prev if prev is not None else torch.empty_like(x)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                out = fn(inp)
            self.steps.append((kind, j, lp, graph, inp, out))
            prev = out

        for kind, j in T.layer_order(cfg):
            stack = "ssm_blocks" if kind == "mamba" else "attn_blocks"
            lp = T.layer(params[stack], j)
            if kind == "mamba":
                graphed(kind, j, lp, lambda h, lp=lp, j=j: _ssm_decode_block(
                    lp, h, cfg, cache, j))
            else:
                self.steps.append((kind, j, lp, None, None, None))
                prev = None
            graphed("moe", j, lp, lambda h, lp=lp: T._serve_ffn(
                lp, h, cfg, "decode.moe"))
        SSM.SSD_CALLS.update(calls[0])
        M.DROPLESS_CALLS.update(calls[1])
        self.key = self._key(params, cache, x)
        global GRAPH_CAPTURES
        GRAPH_CAPTURES += 1


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
    if cfg.family == "ssm_moe":
        return _ssm_moe_prefill(params, cfg, x, positions, n_heads, pad_to)
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


def _ssm_moe_prefill(params, cfg, x, positions, n_heads, pad_to):
    """granite-4.0-h's layers in ``layer_order``, each one's state, conv
    tail or k/v written straight into its stack's slot of the cache."""
    B, S = x.shape[:2]
    cache = init_cache(cfg, max(S, pad_to), B, device=x.device)
    for kind, j in T.layer_order(cfg):
        if kind == "mamba":
            lp = T.layer(params["ssm_blocks"], j)
            with span("prefill.ssm"):
                x, (st, cv) = T._ssm_block(lp, x, cfg)
                cache["state"][j].copy_(st)
                cache["conv"][j].copy_(cv)
        else:
            lp = T.layer(params["attn_blocks"], j)
            x, (k, v) = T._apply_attn_block(lp, x, cfg, positions,
                                            n_heads=n_heads)
            cache["k"][j, :, :S].copy_(k)
            cache["v"][j, :, :S].copy_(v)
        x = T._serve_ffn(lp, x, cfg, "prefill.moe")
    return x, cache


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

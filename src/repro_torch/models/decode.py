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

On the card a decode step of the dense stack, or of ssm_moe on its
batched route, replays CUDA graphs (``DecodeGraphs``): one graph for each
layer's mixer and each FFN, chained through static buffers, replayed
inside its span; the decode-attention op reads the position from the
card, so the attention mixers are captured too, and only the embedding
and the head run op by op.  A deepseek-7b decode step otherwise launches
some 1,100 kernels and granite-4.0-h's some 3,500, and the host, not the
card, would set their pace.  The graphs are captured after the first step
on a cache (which runs op by op) and serve every later step on that cache
whose split plan is the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..kernels import decode_attention as DA
from ..kernels import ssd_decode as SD
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
    the cache updated in place.  ``graphs``: the step's CUDA graphs
    (``DecodeGraphs``), kept by the caller from step to step; a step they
    cannot serve (``DecodeGraphs.serves``) runs op by op."""
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
    if graphs is not None and x.is_cuda and DecodeGraphs.serves(cfg,
                                                                 x.shape[0]):
        return graphs.run(params, cfg, cache, x, pos, n_heads), cache
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, cache, x, pos, n_heads), cache
    if cfg.family == "encdec":
        return _encdec_decode(params, cfg, cache, x, pos, n_heads), cache
    for _, fn in _layers(params, cfg, cache, pos, n_heads):
        x = fn(x)
    return x, cache


def _ssm_decode_block(lp, x, cfg, cache, j):
    """Mamba2 layer ``j``'s decode mixer (norm, the recurrence step, the
    scaled residual), its state and conv tail written in place (by the
    ``ssd_decode`` kernels on the card, copied from the twin's output on
    the CPU)."""
    with span("decode.ssm"):
        h = L.rms_norm(x, lp["norm1"], cfg.rms_eps)
        state, conv = cache["state"][j], cache["conv"][j]
        y, st, cv = SSM.ssd_decode_step(lp["ssm"], h, cfg, state, conv)
        if st is not state:     # the plain twin's new tensors
            state.copy_(st)
            conv.copy_(cv)
        return T._residual(x, y, cfg)


def _attention_mixer(lp, x, cfg, cache, j, pos, n_heads, pos_dev=None):
    """Attention layer ``j``'s decode mixer against its ring cache (norm,
    attention, the scaled residual); ``pos_dev`` as
    ``layers.attention_decode`` takes it."""
    h = L.rms_norm(x, lp["norm1"], cfg.rms_eps)
    out, _, _ = L.attention_decode(lp["attn"], h, cfg, cache["k"][j],
                                   cache["v"][j], pos, n_heads, pos_dev)
    return T._residual(x, out, cfg)


def _layers(params, cfg, cache, pos, n_heads, pos_dev=None) -> list:
    """A dense-stack or ssm_moe decode step after the embedding, as
    (the span its ops open, or None; x -> x) in order: each layer's mixer,
    then its FFN (granite-4.0-h's layers in ``layer_order``, each mixer
    against its own stack's cache, each FFN the dropless MoE)."""
    def mixer(lp, j):
        return lambda x: _attention_mixer(lp, x, cfg, cache, j, pos,
                                          n_heads, pos_dev)

    if cfg.family != "ssm_moe":
        out = []
        for i in range(cfg.n_layers):
            lp = T.layer(params["blocks"], i)
            out += [("decode.attention", mixer(lp, i)),
                    (None, lambda x, lp=lp: T._apply_mlp_or_moe(lp, x,
                                                                cfg)[0])]
        return out
    out = []
    for kind, j in T.layer_order(cfg):
        if kind == "mamba":
            lp = T.layer(params["ssm_blocks"], j)
            out.append(("decode.ssm", lambda x, lp=lp, j=j:
                        _ssm_decode_block(lp, x, cfg, cache, j)))
        else:
            lp = T.layer(params["attn_blocks"], j)
            out.append(("decode.attention", mixer(lp, j)))
        out.append(("decode.moe", lambda x, lp=lp: T._serve_ffn(
            lp, x, cfg, "decode.moe")))
    return out


GRAPH_CAPTURES = 0     # DecodeGraphs captures, counted on the host
GRAPH_REPLAYS = 0      # decode steps DecodeGraphs replayed, on the host

# the call counters a decode step's layers advance (a dict of counts, or
# an int), which a replay advances as its capture did
_COUNTED = ((SSM, "SSD_CALLS"), (SD, "SSD_DECODE_LAUNCHES"),
            (M, "DROPLESS_CALLS"), (DA, "DECODE_ATTN_LAUNCHES"),
            (DA, "ROUTE_LAUNCHES"))


def _calls() -> dict:
    """{(module, counter, key or None): count} of ``_COUNTED``."""
    out = {}
    for mod, name in _COUNTED:
        c = getattr(mod, name)
        if isinstance(c, dict):
            out.update({(mod, name, k): n for k, n in c.items()})
        else:
            out[(mod, name, None)] = c
    return out


def _advance(delta: dict) -> None:
    """Add ``delta`` (keyed as ``_calls`` keys) to the counters."""
    for (mod, name, key), n in delta.items():
        if key is None:
            setattr(mod, name, getattr(mod, name) + n)
        else:
            getattr(mod, name)[key] += n


class DecodeGraphs:
    """CUDA graphs of a decode step on one cache, batch size and split plan
    of the decode-attention op, for the dense stack (dense, vlm and audio
    families) and ssm_moe up to ``moe.BATCHED_MAX_TOKENS`` rows (where its
    MoE takes the batched route): ``serves`` says which.  Every other step
    sizes something on the host (capacity-routed experts, the grouped
    route's groups) and runs op by op.

    One graph for each layer's mixer and each FFN (``_layers``), captured
    in order, the output of one the static input of the next, all in one
    memory pool.  The decode-attention op reads the position from a 0-d
    int32 tensor on the card, written once a step (``fill_``) before the
    replays; the host's position picks the op's split plan, so the plan is
    part of the key.  ``run`` replays each graph inside the span its ops
    would have opened, and advances the call counters as the captured ops
    did (``ssm.SSD_CALLS``, ``ssd_decode.SSD_DECODE_LAUNCHES``,
    ``moe.DROPLESS_CALLS``, ``decode_attention.DECODE_ATTN_LAUNCHES`` and
    ``ROUTE_LAUNCHES``).  The
    first step on a new key runs op by op, and the graphs are captured
    after it: capturing runs nothing, so the cache advances once.
    Recapturing reuses the pool (the old graphs are dropped only once the
    new ones hold it) on a side stream, and frees no cached memory.
    ``run`` returns the last graph's static output, which the next step
    overwrites."""

    def __init__(self):
        self.key = None
        self.graphs = []      # (span name or None, graph), in order
        self.x_in = self.out = None
        self.calls = {}       # the counters a step's captured ops advance
        self.pos = self.pool = self.stream = None

    @staticmethod
    def serves(cfg, rows: int) -> bool:
        """Whether a step of ``rows`` rows of ``cfg`` can be captured."""
        if cfg.family == "ssm_moe":
            return rows <= M.BATCHED_MAX_TOKENS
        return cfg.family in ("dense", "vlm", "audio")

    @staticmethod
    def _key(params, cfg, cache, x, pos, n_heads):
        """What the graphs hold: the params' addresses, the cache's
        addresses, shapes and strides (a captured launch holds the slots
        and strides of its cache, and a smaller cache may land where the
        last one did), the batch size, and the split plan at ``pos``."""
        ck = cache.get("k")
        plan = None if ck is None else DA.decode_plan(
            ck.dtype, x.shape[0], n_heads, cfg.n_kv_heads, ck.shape[2], pos)
        return (x.shape[0], x.dtype, plan,
                *((t.data_ptr(), t.shape, t.stride())
                  for t in cache.values()),
                *(t.data_ptr() for t in tree_leaves(params)))

    def run(self, params, cfg, cache, x, pos, n_heads):
        global GRAPH_REPLAYS
        key = self._key(params, cfg, cache, x, pos, n_heads)
        if key != self.key:
            for _, fn in _layers(params, cfg, cache, pos, n_heads):
                x = fn(x)
            self._capture(params, cfg, cache, x, pos, n_heads)
            self.key = key
            return x
        self.pos.fill_(pos)
        self.x_in.copy_(x)
        for name, graph in self.graphs:
            if name is None:
                graph.replay()
            else:
                with span(name):
                    graph.replay()
        _advance(self.calls)
        GRAPH_REPLAYS += 1
        return self.out

    def _capture(self, params, cfg, cache, x, pos, n_heads):
        global GRAPH_CAPTURES
        self.key = None
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(x.device)
            self.pos = torch.zeros((), dtype=torch.int32, device=x.device)
        before = _calls()
        x_in = torch.empty_like(x)
        graphs, outs = [], [x_in]
        torch.cuda.synchronize(x.device)
        with torch.cuda.stream(self.stream):
            for name, fn in _layers(params, cfg, cache, pos, n_heads,
                                    self.pos):
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=self.pool)
                try:
                    outs.append(fn(outs[-1]))
                finally:
                    graph.capture_end()
                graphs.append((name, graph))
        after = _calls()
        self.calls = {k: n - before[k] for k, n in after.items()
                      if n != before[k]}
        _advance({k: -n for k, n in self.calls.items()})
        self.graphs, self.x_in, self.out = graphs, x_in, outs[-1]
        GRAPH_CAPTURES += 1


def _attn_decode_block(lp, x, cfg, cache, i, pos, n_heads):
    """One attention block's decode step against cache k/v ``i``."""
    x = _attention_mixer(lp, x, cfg, cache, i, pos, n_heads)
    return T._apply_mlp_or_moe(lp, x, cfg)[0]


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

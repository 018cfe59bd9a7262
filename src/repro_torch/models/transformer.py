"""Architecture assembly in torch: the dense, MoE, Mamba2 SSD, Griffin
hybrid and prefix-LM VLM decoder-only families, and the encoder-decoder.

Counterpart of the JAX package's models/transformer.py.  Layer params are
stacked with a leading ``L`` dim, as in JAX; ``lax.scan`` over the stack
becomes a Python loop over ``params["blocks"][...][i]``, and the scan's
per-body ``jax.checkpoint`` (``cfg.remat``) a ``torch.utils.checkpoint``
of the same body: one layer, or one (rec, rec, local_attn) super-block of
the hybrid.  A MoE block (qwen3-moe, arctic) is the dense block with
``moe.moe_ffn`` in place of the MLP; its aux loss is summed over the
layers.  The hybrid keeps its rec and local-attention layers in two stacks
(``rec_blocks``, ``attn_blocks``) and applies them as the reference does:
super-blocks, then the leftover rec layers.  The VLM prepends its stub
patch embeddings (``prefix_emb``) to the text and attends to them
bidirectionally (the prefix-LM mask).  The encoder-decoder keeps an
``encoder`` stack of bidirectional attention layers over the stub frame
embeddings (``src_emb``) and a ``decoder`` stack of "cross" layers: causal
self-attention, cross-attention to the encoder's output (no final norm,
no rope), then the MLP.
A family with no branch of its own (the configs' "audio") takes the
dense, token-only stack at every dispatch, as in the reference.
The ssm_moe family (granite-4.0-h) keeps its Mamba2 and attention layers
in two stacks (``ssm_blocks``, ``attn_blocks``) and applies them in
``cfg.layer_types`` order (``layer_order``); every layer is a mixer then
the dropless MoE FFN with its shared expert, each branch scaled by
``cfg.residual_multiplier`` before it is added.

  forward_train(params, cfg, batch) -> (hidden, aux_loss)
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..spans import span
from ..tree import tree_map
from . import layers as L
from . import moe as M
from . import rglru as R
from . import ssm as SSM
from .attention_flash import blockwise_attention

Params = dict

# ======================================================================
# init
# ======================================================================

def _block_init(gen: torch.Generator, cfg, kind: str, tp_pad: int) -> Params:
    dt = L._dtype(cfg)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt,
                              device=L.init_device(gen))
    if kind == "ssm":
        return {"ssm": SSM.init_ssm(gen, cfg), "norm1": ones()}
    if kind == "ssm_moe":
        return {"norm1": ones(), "ssm": SSM.init_ssm(gen, cfg),
                "norm2": ones(), "moe": M.init_moe(gen, cfg)}
    if kind == "rec":
        return {"norm1": ones(), "rec": R.init_rglru_block(gen, cfg),
                "norm2": ones(), "mlp": L.init_mlp(gen, cfg)}
    if kind not in ("attn", "moe", "local_attn", "cross"):
        raise ValueError(kind)
    p = {"norm1": ones(), "attn": L.init_attention(gen, cfg, tp_pad),
         "norm2": ones()}
    if kind == "cross":     # the encoder-decoder's decoder block
        p["xattn"] = L.init_attention(gen, cfg, tp_pad)
        p["norm3"] = ones()
    if kind == "moe":
        p["moe"] = M.init_moe(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def _stack(gen: torch.Generator, cfg, kind: str, n: int,
           tp_pad: int) -> Params:
    """n layers' params stacked on a leading dim, filled layer by layer so
    that only one layer exists outside the stack at a time."""
    first = _block_init(gen, cfg, kind, tp_pad)
    out = tree_map(lambda a: a.new_empty((n, *a.shape)), first)

    def put(i, layer):
        tree_map(lambda dst, src: dst[i].copy_(src), out, layer)

    put(0, first)
    del first
    for i in range(1, n):
        put(i, _block_init(gen, cfg, kind, tp_pad))
    return out


def block_kinds(cfg) -> list[str]:
    """The block sequence of an architecture."""
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "moe":
        return ["moe"] * cfg.n_layers
    if cfg.family == "hybrid":
        return ["local_attn" if (i + 1) % cfg.attn_every == 0 else "rec"
                for i in range(cfg.n_layers)]
    if cfg.family == "ssm_moe":
        return ["moe" if t == "attention" else "ssm_moe"
                for t in cfg.layer_types]
    return ["attn"] * cfg.n_layers


def layer_order(cfg) -> list[tuple[str, int]]:
    """The ssm_moe layers in order as (layer type, index in its stack):
    ``"mamba"`` indexes ``ssm_blocks``, ``"attention"`` ``attn_blocks``."""
    types = cfg.layer_types
    return [(t, types[:i].count(t)) for i, t in enumerate(types)]


def hybrid_layout(cfg) -> tuple[int, int]:
    """(n_super, n_left) of the hybrid: super-block s applies rec layers
    s and n_super + s, then attention layer s (the reference reshapes the
    first 2 n_super rec layers to (2, n_super) and swaps the axes); the
    n_left rec layers after them follow."""
    n_attn = block_kinds(cfg).count("local_attn")
    return n_attn, cfg.n_layers - 3 * n_attn


def init_model(gen: torch.Generator | None, cfg, tp_pad: int = 1) -> Params:
    """Draws every param from ``gen`` on its device; with ``gen=None`` the
    leaves are made on the meta device and nothing is drawn (the dry-run's
    ``param_shapes``).  tp_pad: q-heads are padded up to a multiple of it
    (zero-weight pad heads)."""
    params: Params = {"embed": L.init_embedding(gen, cfg)}
    if cfg.family == "encdec":
        params["encoder"] = _stack(gen, cfg, "attn", cfg.enc_layers, tp_pad)
        params["decoder"] = _stack(gen, cfg, "cross", cfg.dec_layers, tp_pad)
        return params
    if cfg.family == "hybrid":
        n_super, n_left = hybrid_layout(cfg)
        params["rec_blocks"] = _stack(gen, cfg, "rec", 2 * n_super + n_left,
                                      tp_pad)
        params["attn_blocks"] = _stack(gen, cfg, "local_attn", n_super,
                                       tp_pad)
        return params
    if cfg.family == "ssm_moe":
        n_attn = cfg.layer_types.count("attention")
        params["ssm_blocks"] = _stack(gen, cfg, "ssm_moe",
                                      cfg.n_layers - n_attn, tp_pad)
        params["attn_blocks"] = _stack(gen, cfg, "moe", n_attn, tp_pad)
        return params
    params["blocks"] = _stack(gen, cfg, block_kinds(cfg)[0], cfg.n_layers,
                              tp_pad)
    return params


def layer(stack: Params, i: int) -> Params:
    """Layer ``i``'s params: views into the stacked tensors."""
    return tree_map(lambda a: a[i], stack)


def _grad_slot(a: torch.Tensor, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked leaf as a leaf of its own whose gradient is
    added into ``a.grad[i]`` as soon as it is ready, then dropped.

    Autograd's backward of the view ``a[i]`` would write a zero tensor of
    ``a``'s full size for every layer (30 x 12.1 GB per step at
    deepseek-7b's full width); this writes each layer's slice once and
    keeps one layer's gradient alive at a time.  ``a.grad`` is allocated
    (zeros) by the first layer's gradient and accumulates like any
    ``.grad``."""
    if not a.requires_grad:
        return a[i]
    t = a[i].detach().requires_grad_()

    def flush(t):
        if a.grad is None:
            a.grad = torch.zeros_like(a)
        a.grad[i].add_(t.grad)
        t.grad = None
    t.register_post_accumulate_grad_hook(flush)
    return t


# ======================================================================
# block apply (full sequence)
# ======================================================================

def _residual(x, y, cfg):
    """x + residual_multiplier * y, one op either way."""
    if cfg.residual_multiplier == 1.0:
        return x + y
    return torch.add(x, y, alpha=cfg.residual_multiplier)


def _apply_attn_block(p: Params, x, cfg, positions, *, n_heads, window=0,
                      prefix=0, causal=True, kv_override=None):
    """-> (x + attention(norm1(x)), (k, v)).  With ``kv_override`` (the
    encoder's output, cross-attention) k and v are its projections, taken
    as it is, and neither q nor k is rotated."""
    h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
    B, Sq, d = h.shape
    src = h if kv_override is None else kv_override
    q = L._split_heads(h @ p["attn"]["wq"], n_heads, cfg.head_dim)
    k = L._split_heads(src @ p["attn"]["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = L._split_heads(src @ p["attn"]["wv"], cfg.n_kv_heads, cfg.head_dim)
    if kv_override is None:
        q = L.apply_rope(q, positions, cfg.rotary_pct, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rotary_pct, cfg.rope_theta)
    scale = L.softmax_scale(cfg)
    if cfg.attn_impl == "flash_pallas":
        from ..kernels.ops import flash_attention
        out = flash_attention(q, k, v, cfg.n_kv_heads, causal, window,
                              prefix, cfg.flash_bq, cfg.flash_bk, scale)
    elif cfg.attn_impl == "flash":
        out = blockwise_attention(q, k, v, cfg.n_kv_heads, causal=causal,
                                  window=window, prefix=prefix,
                                  bq=cfg.flash_bq, bk=cfg.flash_bk,
                                  scale=scale)
    elif cfg.attn_impl == "flash_cvjp":
        if scale is not None:
            raise ValueError("flash_cvjp takes the 1/sqrt(D) scale only")
        from .attention_flash_vjp import flash_attention
        out = flash_attention(q, k, v, cfg.n_kv_heads, causal, window,
                              prefix, cfg.flash_bq, cfg.flash_bk)
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    x = _residual(x, out.reshape(B, Sq, -1) @ p["attn"]["wo"], cfg)
    return x, (k, v)


def _apply_mlp_or_moe(p: Params, x, cfg, n_groups=1):
    """-> (x + ffn(norm(x)), aux): the MoE layer's load-balance loss, or 0
    after a dense MLP."""
    h = L.rms_norm(x, p["norm2"], cfg.rms_eps)
    if "moe" in p:
        y, aux = M.moe_ffn(p["moe"], h, cfg, n_groups=n_groups)
        return _residual(x, y, cfg), aux
    y = L.apply_mlp(p["mlp"], h, cfg)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_block(p, x, cfg, positions, *, n_heads, window, prefix,
                 n_groups=1, collect_kv=False):
    x, kv = _apply_attn_block(p, x, cfg, positions, n_heads=n_heads,
                              window=window, prefix=prefix)
    x, aux = _apply_mlp_or_moe(p, x, cfg, n_groups=n_groups)
    return x, aux, (kv if collect_kv else None)


def _enc_block(p, x, cfg, positions, *, n_heads):
    """-> (x', aux): the encoder's bidirectional attention and MLP."""
    x, _ = _apply_attn_block(p, x, cfg, positions, n_heads=n_heads,
                             causal=False)
    return _apply_mlp_or_moe(p, x, cfg)


def _cross_block(p, x, enc_out, cfg, positions, *, n_heads,
                 collect_kv=False):
    """-> (x', aux, ((k, v), (xk, xv)) or None): the decoder's causal
    self-attention (norm1), cross-attention to ``enc_out`` (norm3), MLP
    (norm2)."""
    x, kv = _apply_attn_block(p, x, cfg, positions, n_heads=n_heads,
                              causal=True)
    x, xkv = _apply_attn_block({"attn": p["xattn"], "norm1": p["norm3"]}, x,
                               cfg, positions, n_heads=n_heads, causal=False,
                               kv_override=enc_out)
    x, aux = _apply_mlp_or_moe(p, x, cfg)
    return x, aux, ((kv, xkv) if collect_kv else None)


def _rec_block(p, x, cfg, state=None, conv_state=None):
    """-> (x', h_final, conv tail): the RG-LRU block and the MLP."""
    h = L.rms_norm(x, p["norm1"])
    y, h_final, new_conv = R.rglru_block(p["rec"], h, cfg, state=state,
                                         conv_state=conv_state)
    x, _ = _apply_mlp_or_moe(p, x + y, cfg)
    return x, h_final, new_conv


def _ssm_block(p, x, cfg, state=None):
    """-> (x', (final state, conv tail))."""
    h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
    y, final, conv_tail = SSM.ssd_forward(p["ssm"], h, cfg,
                                          initial_state=state)
    return _residual(x, y, cfg), (final, conv_tail)


def _serve_ffn(p, x, cfg, name: str):
    """The ssm_moe layer's FFN when serving, inside span ``name``: the
    norm, the dropless MoE and its shared expert (no aux loss), the
    scaled residual."""
    with span(name):
        h = L.rms_norm(x, p["norm2"], cfg.rms_eps)
        return _residual(x, M.dropless_ffn(p["moe"], h, cfg)[0], cfg)


# ======================================================================
# full-sequence forward
# ======================================================================

def _sinusoidal(positions, d):
    pos = positions.float()[..., None]
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = pos * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_inputs(params, cfg, batch):
    """Returns (x (B,S,d), positions (B,S)); the VLM's stub patch
    embeddings come first, and positions run over them too."""
    x = L.embed(params["embed"], batch["tokens"], cfg.embedding_multiplier)
    if cfg.family == "vlm":
        x = torch.cat([batch["prefix_emb"].to(x.dtype), x], dim=1)
    x = L.shard_batch(x)
    B, Sx = x.shape[:2]
    positions = torch.arange(Sx, device=x.device)[None].expand(B, Sx)
    if cfg.rotary_pct == 0.0 and not cfg.nope:
        x = x + _sinusoidal(positions, cfg.d_model).to(x.dtype)
    return x, positions


def _encoder_input(cfg, src_emb):
    """The encoder's input: the stub frame embeddings in the params' dtype
    plus the sinusoidal table; -> (x (B,Se,d), positions (B,Se))."""
    x = src_emb.to(L._dtype(cfg))
    B, Se, d = x.shape
    positions = torch.arange(Se, device=x.device)[None].expand(B, Se)
    return x + _sinusoidal(positions, d).to(x.dtype), positions


def _run_bodies(bodies, x, checkpointed: bool, *extra):
    """Apply (body, layer params) pairs in order -> (x, the summed aux).
    With ``checkpointed`` each body runs under ``checkpoint``; ``extra``
    inputs (the encoder's output) go into every body as explicit inputs,
    so their gradient is summed over the bodies."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for body, lp in bodies:
        if checkpointed:
            x, aux_i = checkpoint(body, lp, x, *extra, use_reentrant=False)
        else:
            x, aux_i = body(lp, x, *extra)
        aux = aux + aux_i
    return x, aux


def forward_train(params: Params, cfg, batch, n_groups: int = 1):
    """-> (hidden (B,S,d), aux_loss); S includes the VLM's prefix.

    Differentiable in the params that require grad: a backward pass leaves
    each leaf's gradient in its ``.grad``, the stacked block leaves
    included (filled layer by layer, see ``_grad_slot``).  With
    ``cfg.remat`` each body (a layer, or a hybrid super-block) is
    checkpointed, so only its input is kept and its forward runs again
    during the backward pass."""
    n_heads = params_n_heads(params, cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    grad = torch.is_grad_enabled()
    checkpointed = grad and cfg.remat
    zero = lambda: torch.zeros((), dtype=torch.float32, device=x.device)

    def take(stack, i):
        if grad:
            return tree_map(lambda a: _grad_slot(a, i), stack)
        return layer(stack, i)

    if cfg.family == "encdec":
        enc_x, enc_pos = _encoder_input(cfg, batch["src_emb"])

        def enc(lp, xx):
            return _enc_block(lp, xx, cfg, enc_pos, n_heads=n_heads)

        def dec(lp, xx, enc_out):
            y, aux_i, _ = _cross_block(lp, xx, enc_out, cfg, positions,
                                       n_heads=n_heads)
            return y, aux_i
        # the encoder's output goes into every decoder layer as it is
        enc_out, _ = _run_bodies(((enc, take(params["encoder"], i))
                                  for i in range(cfg.enc_layers)), enc_x,
                                 checkpointed)
        return _run_bodies(((dec, take(params["decoder"], i))
                            for i in range(cfg.dec_layers)), x,
                           checkpointed, enc_out)
    if cfg.family == "ssm":
        def block(lp, xx):
            return _ssm_block(lp, xx, cfg)[0], zero()
        bodies = ((block, take(params["blocks"], i))
                  for i in range(cfg.n_layers))
    elif cfg.family == "hybrid":
        n_super, n_left = hybrid_layout(cfg)
        rec, attn = params["rec_blocks"], params["attn_blocks"]

        def super_block(lp, xx):
            for sub in lp["rec"]:
                xx, _, _ = _rec_block(sub, xx, cfg)
            xx, aux_i, _ = _dense_block(lp["attn"], xx, cfg, positions,
                                        n_heads=n_heads,
                                        window=cfg.local_window, prefix=0)
            return xx, aux_i

        def leftover(lp, xx):
            return _rec_block(lp, xx, cfg)[0], zero()
        bodies = [(super_block, {"rec": [take(rec, s),
                                         take(rec, n_super + s)],
                                 "attn": take(attn, s)})
                  for s in range(n_super)]
        bodies += [(leftover, take(rec, 2 * n_super + t))
                   for t in range(n_left)]
    elif cfg.family == "ssm_moe":
        def mamba(lp, xx):
            return _apply_mlp_or_moe(lp, _ssm_block(lp, xx, cfg)[0], cfg)

        def attention(lp, xx):
            xx, _ = _apply_attn_block(lp, xx, cfg, positions,
                                      n_heads=n_heads)
            return _apply_mlp_or_moe(lp, xx, cfg)
        bodies = [(mamba, take(params["ssm_blocks"], j)) if t == "mamba"
                  else (attention, take(params["attn_blocks"], j))
                  for t, j in layer_order(cfg)]
    else:
        prefix = cfg.n_prefix_tokens if cfg.family == "vlm" else 0

        def block(lp, xx):
            y, aux_i, _ = _dense_block(lp, xx, cfg, positions,
                                       n_heads=n_heads,
                                       window=cfg.swa_window, prefix=prefix,
                                       n_groups=n_groups)
            return y, aux_i
        bodies = ((block, take(params["blocks"], i))
                  for i in range(cfg.n_layers))
    return _run_bodies(bodies, x, checkpointed)


def params_n_heads(params: Params, cfg) -> int:
    """Recover the (possibly TP-padded) q-head count from the weights."""
    if cfg.family == "ssm":
        return 0
    stack = {"hybrid": "attn_blocks", "encdec": "decoder",
             "ssm_moe": "attn_blocks"}.get(cfg.family, "blocks")
    return params[stack]["attn"]["wq"].shape[-1] // cfg.head_dim

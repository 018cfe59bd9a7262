"""granite-4.0-h-small's plain reference: the published ``GraniteMoeHybrid``
decoder, in fp32 from the bf16 weights (TF32 off, ``plain.exact``), through
``cbench.plain``'s blocks and plain PyTorch.

    x = embed(tokens) * embedding_multiplier
    each layer, in ``layer_types`` order:
        x = x + residual_multiplier * mixer(rmsnorm(x))
        h = rmsnorm(x)
        x = x + residual_multiplier * (moe(h) + shared(h))
    logits = rmsnorm(x) @ embed.T / logits_scaling

- Mamba2 mixer: ``in_proj`` gives z, x, B, C and dt; a depthwise causal
  conv with bias over (x, B, C), then silu; ``dt = softplus(dt +
  dt_bias)`` (no clamp), ``A = -exp(A_log)``; the state-space recurrence
  taken step by step, one position at a time,
  ``s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t^T``, ``y_t = C_t^T s_t + D
  x_t`` (one group: B and C shared by the heads); the gated norm
  ``rmsnorm(y * silu(z))`` over all ``expand * d`` channels; ``out_proj``.
- Attention: GQA with no position encoding, softmax scale
  ``attention_multiplier``, causal.
- MoE: fp32 router logits, the top k, a softmax over those k; each expert
  computed over the tokens routed to it, every choice (dropless); the
  shared SwiGLU expert on every token.

Departures from the published model, none of them in the mathematics: the
recurrence runs sequentially where the published kernels run it in chunks
(the same sums in another order); the router's matrix is an fp32 leaf (the
port's layout for every router; the checkpoint stores it in bf16);
``plain.attention`` divides by sqrt(D), so q enters it times
``attention_multiplier * sqrt(D)``.  With ``prec="fp8"`` every matrix
product and the attention's q, k and v go through fp8 (the control).

It imports nothing of the program.  Its layout is the program's param tree
(keys, shapes, dtypes, the layers stacked by type in ``ssm_blocks`` and
``attn_blocks``), so that the benchmark can hand the same weights to both.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cbench import plain

STACKS = ("ssm_blocks", "attn_blocks")
# The tied embedding's std.  At 0.02 the head's logit for the current
# token (12 x its embedding rides the residual stream) beats every other,
# and the model repeats its last prompt token: every served token then
# agrees with the reference whatever the precision (chat cell on an H100,
# 2 seeds: copy rate 1.0, token_gap 0 for the program and the fp8 control
# alike).  At 0.005 it copies 4 % of the time, and the control reads 4-5x
# the program.
TOK_STD = 0.005


def spec(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    run = cfg["run"]
    s = {"family": run["family"], "d_model": d,
         "layers": cfg["num_hidden_layers"], "heads": H,
         "kv_heads": cfg["num_key_value_heads"], "head_dim": d // H,
         "d_ff": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
         "padded_vocab": run["padded_vocab_size"],
         "n_experts": cfg["num_local_experts"],
         "experts_per_token": cfg["num_experts_per_tok"],
         "moe_dense_ff": cfg["shared_intermediate_size"],
         "moe_dropless": True,
         "ssm_state": cfg["mamba_d_state"], "ssm_headdim": cfg["mamba_d_head"],
         "ssm_expand": cfg["mamba_expand"],
         "ssm_chunk": cfg["mamba_chunk_size"],
         "conv_width": cfg["mamba_d_conv"],
         "ssm_conv_bias": cfg["mamba_conv_bias"],
         "layer_types": tuple(cfg["layer_types"]),
         "rms_eps": cfg["rms_norm_eps"],
         "embedding_multiplier": float(cfg["embedding_multiplier"]),
         "residual_multiplier": float(cfg["residual_multiplier"]),
         "attention_multiplier": float(cfg["attention_multiplier"]),
         "logits_scaling": float(cfg["logits_scaling"]),
         "tie_embeddings": cfg["tie_word_embeddings"],
         "nope": cfg["position_embedding_type"] == "nope",
         "rotary_pct": 0.0,
         "stacks": STACKS,
         "optimizer": run["optimizer"],
         "grad_compression": run["grad_compression"], "remat": run["remat"]}
    if s["ssm_expand"] * d // s["ssm_headdim"] != cfg["mamba_n_heads"] \
            or cfg["mamba_n_groups"] != 1 or not s["nope"] \
            or not s["tie_embeddings"]:
        raise ValueError("the reference takes expand * d / head Mamba2 "
                         "heads in one group, no position encoding and a "
                         "tied head")
    return s


def _counts(s: dict) -> dict:
    n_attn = s["layer_types"].count("attention")
    d = s["d_model"]
    din = s["ssm_expand"] * d
    return {"n_attn": n_attn, "n_ssm": s["layers"] - n_attn, "din": din,
            "H": din // s["ssm_headdim"], "conv": din + 2 * s["ssm_state"]}


def _ffn_layout(stack: str, n: int, s: dict) -> list:
    d, E, ff, sff = s["d_model"], s["n_experts"], s["d_ff"], s["moe_dense_ff"]
    w = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))
    return [(f"{stack}/norm2", (n, d), ("ones",)),
            (f"{stack}/moe/router", (n, d, E), w(d), "float32"),
            (f"{stack}/moe/w_gate", (n, E, d, ff), w(d)),
            (f"{stack}/moe/w_up", (n, E, d, ff), w(d)),
            (f"{stack}/moe/w_down", (n, E, ff, d), w(ff)),
            (f"{stack}/moe/dense/w_gate", (n, d, sff), w(d)),
            (f"{stack}/moe/dense/w_up", (n, d, sff), w(d)),
            (f"{stack}/moe/dense/w_down", (n, sff, d), w(sff))]


def layout(s: dict) -> list:
    d, V, N = s["d_model"], s["padded_vocab"], s["ssm_state"]
    c = _counts(s)
    Ls, La, din, H = c["n_ssm"], c["n_attn"], c["din"], c["H"]
    q, kv = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    w = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))
    taps = ("uniform", -0.5, 0.5)
    return ([("embed/tok", (V, d), ("normal", TOK_STD)),
             ("embed/final_norm", (d,), ("ones",)),
             ("ssm_blocks/norm1", (Ls, d), ("ones",)),
             ("ssm_blocks/ssm/w_in", (Ls, d, 2 * din + 2 * N + H), w(d)),
             ("ssm_blocks/ssm/conv", (Ls, s["conv_width"], c["conv"]), taps),
             ("ssm_blocks/ssm/conv_bias", (Ls, c["conv"]), taps),
             ("ssm_blocks/ssm/a_log", (Ls, H), ("log_of_uniform", 1.0, 16.0),
              "float32"),
             ("ssm_blocks/ssm/d_skip", (Ls, H), ("ones",), "float32"),
             ("ssm_blocks/ssm/dt_bias", (Ls, H),
              ("softplus_inv_log_uniform", 1e-3, 0.1), "float32"),
             ("ssm_blocks/ssm/w_out", (Ls, din, d), w(din)),
             ("ssm_blocks/ssm/out_norm", (Ls, din), ("ones",))]
            + _ffn_layout("ssm_blocks", Ls, s)
            + [("attn_blocks/norm1", (La, d), ("ones",)),
               ("attn_blocks/attn/wq", (La, d, q), w(d)),
               ("attn_blocks/attn/wk", (La, d, kv), w(d)),
               ("attn_blocks/attn/wv", (La, d, kv), w(d)),
               ("attn_blocks/attn/wo", (La, q, d), w(q))]
            + _ffn_layout("attn_blocks", La, s))


def input_shapes(s: dict, B: int, S: int) -> dict:
    return {"tokens": ((B, S), "tokens")}


def attention_calls(s: dict, B: int, S: int) -> list:
    """The attention calls of one forward over B x S positions:
    (B, heads, head_dim, Sq, Sk, causal, calls), the attention layers
    alone."""
    return [(B, s["heads"], s["head_dim"], S, S, True,
             s["layer_types"].count("attention"))]


def prefill_flops(spec: dict, B: int, S: int) -> float:
    """Model FLOPs of a prefill of B prompts of S tokens, whatever
    implements it.

    - 2 per weight a token passes through: each Mamba2 layer's in_proj,
      conv taps and out_proj; each attention layer's four projections;
      every layer's router, its k routed experts (3 d ff each, not the E
      it holds) and its shared expert; the tied head on the last position
      alone (2 d V a prompt).  The embedding is a lookup.
    - The state-space products of each Mamba2 layer and prompt, chunked
      at ``ssm_chunk`` positions (the published chunk): for a chunk of q
      positions, C B^T (2 q^2 N), the decay-masked (q, q) matrix times x
      in each head (2 H q^2 P), the chunk's state B^T (dt x) (2 H q N P)
      and the earlier chunks' part C^T h (2 H q N P).
    - 4 H D a causal (query, key) pair in each attention layer (q.k and
      p.v)."""
    s, c = spec, _counts(spec)
    d, N, H, P = s["d_model"], s["ssm_state"], c["H"], s["ssm_headdim"]
    din, Q = c["din"], s["ssm_chunk"]
    q, kv = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    mamba = d * (2 * din + 2 * N + H) + s["conv_width"] * c["conv"] \
        + din * d
    attn = 2 * d * q + 2 * d * kv
    ffn = d * s["n_experts"] + s["experts_per_token"] * 3 * d * s["d_ff"] \
        + 3 * d * s["moe_dense_ff"]
    per_token = c["n_ssm"] * mamba + c["n_attn"] * attn + s["layers"] * ffn
    ssd = sum(2.0 * (qc * qc * N + H * qc * qc * P + 2 * H * qc * N * P)
              for qc in (min(Q, S - i) for i in range(0, S, Q)))
    pairs = S * (S + 1) / 2
    return (2.0 * per_token * B * S + 2.0 * d * s["padded_vocab"] * B
            + c["n_ssm"] * B * ssd
            + 4.0 * B * s["heads"] * s["head_dim"] * pairs * c["n_attn"])


class Model:
    def __init__(self, s: dict, prec: str = "fp32"):
        self.s, self.prec = s, prec
        self.c = _counts(s)

    def _w(self, params, path, i):
        return params[path][i].float()

    def _residual(self, x, y):
        return x + self.s["residual_multiplier"] * y

    def mamba(self, params, j, x):
        s, c, prec = self.s, self.c, self.prec
        W = lambda name: self._w(params, f"ssm_blocks/{name}", j)
        n, T, _ = x.shape
        N, P, H, din = s["ssm_state"], s["ssm_headdim"], c["H"], c["din"]
        h = plain.rms_norm(x, W("norm1"), s["rms_eps"])
        z, xbc, dt = torch.split(plain.mm(h, W("ssm/w_in"), prec),
                                 [din, c["conv"], H], dim=-1)
        taps = W("ssm/conv")
        K = taps.shape[0]
        xp = F.pad(xbc, (0, 0, K - 1, 0))
        conv = W("ssm/conv_bias") + sum(xp[:, i:i + T] * taps[i]
                                        for i in range(K))
        xs, Bm, Cm = torch.split(plain.silu(conv), [din, N, N], dim=-1)
        dt = F.softplus(dt + W("ssm/dt_bias"))                 # (n, T, H)
        a = torch.exp(dt * -torch.exp(W("ssm/a_log")))         # (n, T, H)
        xs = xs.reshape(n, T, H, P)
        u = dt[..., None] * xs                                 # dt_t x_t
        state = x.new_zeros((n, H, N, P))
        ys = torch.empty_like(xs)
        for t in range(T):
            state = state * a[:, t, :, None, None] \
                + Bm[:, t, None, :, None] * u[:, t, :, None, :]
            ys[:, t] = (Cm[:, t, None, None, :] @ state)[:, :, 0]
        y = (ys + W("ssm/d_skip")[:, None] * xs).reshape(n, T, din)
        y = plain.rms_norm(y * plain.silu(z), W("ssm/out_norm"), s["rms_eps"])
        return self._residual(x, plain.mm(y, W("ssm/w_out"), prec))

    def attention(self, params, j, x):
        s, prec = self.s, self.prec
        W = lambda name: self._w(params, f"attn_blocks/{name}", j)
        n, T, _ = x.shape
        Hq, Hkv, D = s["heads"], s["kv_heads"], s["head_dim"]
        h = plain.rms_norm(x, W("norm1"), s["rms_eps"])
        q = plain.mm(h, W("attn/wq"), prec).view(n, T, Hq, D)
        k = plain.mm(h, W("attn/wk"), prec).view(n, T, Hkv, D)
        v = plain.mm(h, W("attn/wv"), prec).view(n, T, Hkv, D)
        # q head i reads k/v head i // G
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
        q = q * (s["attention_multiplier"] * math.sqrt(D))
        o = plain.attention(q, k, v, True, prec).reshape(n, T, Hq * D)
        return self._residual(x, plain.mm(o, W("attn/wo"), prec))

    def ffn(self, params, stack, j, x):
        s, prec = self.s, self.prec
        W = lambda name: params[f"{stack}/{name}"][j]
        h = plain.rms_norm(x, W("norm2").float(), s["rms_eps"])
        h2 = h.reshape(-1, h.shape[-1])
        logits = plain.mm(h2, W("moe/router").float(), prec)
        top, expert = torch.topk(logits, s["experts_per_token"], dim=-1)
        gate = torch.softmax(top, dim=-1)
        y = torch.zeros_like(h2)
        for e in range(s["n_experts"]):
            tok, slot = torch.nonzero(expert == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = h2[tok]
            a = plain.silu(plain.mm(xe, W("moe/w_gate")[e].float(), prec)) \
                * plain.mm(xe, W("moe/w_up")[e].float(), prec)
            ye = plain.mm(a, W("moe/w_down")[e].float(), prec)
            y.index_add_(0, tok, ye * gate[tok, slot, None])
        shared = plain.mm(
            plain.silu(plain.mm(h2, W("moe/dense/w_gate").float(), prec))
            * plain.mm(h2, W("moe/dense/w_up").float(), prec),
            W("moe/dense/w_down").float(), prec)
        return self._residual(x, (y + shared).view_as(x))

    def hidden(self, params, tokens):
        s = self.s
        x = params["embed/tok"][tokens.long()].float() \
            * s["embedding_multiplier"]
        seen = {"mamba": 0, "attention": 0}
        with torch.no_grad():
            for kind in s["layer_types"]:
                j = seen[kind]
                seen[kind] += 1
                if kind == "mamba":
                    x = self.ffn(params, "ssm_blocks", j,
                                 self.mamba(params, j, x))
                else:
                    x = self.ffn(params, "attn_blocks", j,
                                 self.attention(params, j, x))
        return x

    @torch.no_grad()
    def logits(self, params, tokens, rows):
        """tokens: (n, T); -> fp32 logits at positions ``rows`` (a slice)."""
        s = self.s
        x = self.hidden(params, tokens)
        h = plain.rms_norm(x[:, rows], params["embed/final_norm"].float(),
                           s["rms_eps"])
        tok = params["embed/tok"].float()
        return plain.mm(h, tok.t(), self.prec) / s["logits_scaling"]

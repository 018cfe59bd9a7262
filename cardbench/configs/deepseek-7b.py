"""deepseek-7b's plain reference: a llama decoder (RMSNorm, rotary q/k with
the halves rotated, multi-head causal attention, SwiGLU MLP, untied head),
in fp32 from the bf16 weights, through ``cbench.plain``'s blocks.

It imports nothing of the program.  Its layout is the program's param tree
(keys, shapes, the layers stacked on a leading dim), so that the benchmark
can hand the same weights to both.
"""
from __future__ import annotations

import math

import torch

from cbench import plain

LAYER = ("blocks/norm1", "blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv",
         "blocks/attn/wo", "blocks/norm2", "blocks/mlp/w_gate",
         "blocks/mlp/w_up", "blocks/mlp/w_down")


def spec(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    run = cfg["run"]
    return {"family": "dense", "d_model": d, "layers": cfg["num_hidden_layers"],
            "heads": H, "kv_heads": cfg["num_key_value_heads"],
            "head_dim": d // H, "d_ff": cfg["intermediate_size"],
            "vocab": cfg["vocab_size"], "padded_vocab": run["padded_vocab_size"],
            "eps": cfg["rms_norm_eps"], "rope_theta": cfg["rope_theta"],
            "optimizer": run["optimizer"],
            "grad_compression": run["grad_compression"],
            "remat": run["remat"]}


def layout(s: dict) -> list:
    d, L, ff, V = s["d_model"], s["layers"], s["d_ff"], s["padded_vocab"]
    q, kv = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    n = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))
    return [("embed/tok", (V, d), ("normal", 0.02)),
            ("embed/head", (d, V), n(d)),
            ("embed/final_norm", (d,), ("ones",)),
            ("blocks/norm1", (L, d), ("ones",)),
            ("blocks/attn/wq", (L, d, q), n(d)),
            ("blocks/attn/wk", (L, d, kv), n(d)),
            ("blocks/attn/wv", (L, d, kv), n(d)),
            ("blocks/attn/wo", (L, q, d), n(q)),
            ("blocks/norm2", (L, d), ("ones",)),
            ("blocks/mlp/w_gate", (L, d, ff), n(d)),
            ("blocks/mlp/w_up", (L, d, ff), n(d)),
            ("blocks/mlp/w_down", (L, ff, d), n(ff))]


def input_shapes(s: dict, B: int, S: int) -> dict:
    return {"tokens": ((B, S), "tokens")}


def attention_calls(s: dict, B: int, S: int) -> list:
    """The attention calls of one forward over B x S positions:
    (B, heads, head_dim, Sq, Sk, causal, calls)."""
    return [(B, s["heads"], s["head_dim"], S, S, True, s["layers"])]


class Model:
    def __init__(self, s: dict, prec: str = "fp32"):
        if s["kv_heads"] != s["heads"]:
            raise ValueError("the reference takes one k/v head a q head")
        self.s, self.prec = s, prec

    def _weights(self, params, i, grad=False):
        return {p: params[p][i].detach().float().requires_grad_(grad)
                for p in LAYER}

    def layer(self, W, x):
        s, prec = self.s, self.prec
        B, S, _ = x.shape
        H, D, eps = s["heads"], s["head_dim"], s["eps"]
        pos = torch.arange(S, device=x.device)
        h = plain.rms_norm(x, W["blocks/norm1"], eps)
        q = plain.mm(h, W["blocks/attn/wq"], prec).view(B, S, H, D)
        k = plain.mm(h, W["blocks/attn/wk"], prec).view(B, S, H, D)
        v = plain.mm(h, W["blocks/attn/wv"], prec).view(B, S, H, D)
        q = plain.rope(q, pos, s["rope_theta"])
        k = plain.rope(k, pos, s["rope_theta"])
        o = plain.attention(q, k, v, True, prec).reshape(B, S, H * D)
        x = x + plain.mm(o, W["blocks/attn/wo"], prec)
        h = plain.rms_norm(x, W["blocks/norm2"], eps)
        a = plain.silu(plain.mm(h, W["blocks/mlp/w_gate"], prec)) \
            * plain.mm(h, W["blocks/mlp/w_up"], prec)
        return x + plain.mm(a, W["blocks/mlp/w_down"], prec)

    def hidden(self, params, tokens, keep_inputs=False):
        x = params["embed/tok"][tokens.long()].float()
        inputs = []
        with torch.no_grad():
            for i in range(self.s["layers"]):
                if keep_inputs:
                    inputs.append(x)
                x = self.layer(self._weights(params, i), x)
        return x, inputs

    def loss_and_grads(self, params, batch):
        """-> (loss, grads path -> fp32 leaf): the forward keeps each
        layer's input; the backward runs each layer again under autograd."""
        tokens = batch["tokens"]
        x, inputs = self.hidden(params, tokens, keep_inputs=True)
        loss, dx, dnorm, dhead = plain.head_backward(
            x, params["embed/final_norm"], params["embed/head"], tokens,
            self.s["eps"], self.prec)
        grads = {"embed/head": dhead, "embed/final_norm": dnorm}
        for p in LAYER:
            grads[p] = torch.zeros(params[p].shape, dtype=torch.float32,
                                   device=dx.device)
        for i in reversed(range(self.s["layers"])):
            W = self._weights(params, i, grad=True)
            xin = inputs[i].requires_grad_()
            with torch.enable_grad():
                y = self.layer(W, xin)
            y.backward(dx)
            dx = xin.grad
            inputs[i] = None
            for p in LAYER:
                grads[p][i] = W[p].grad
        tok = params["embed/tok"]
        dtok = torch.zeros(tok.shape, dtype=torch.float32, device=dx.device)
        dtok.index_add_(0, tokens.reshape(-1).long(),
                        dx.reshape(-1, dx.shape[-1]))
        grads["embed/tok"] = dtok
        return loss, grads

    @torch.no_grad()
    def logits(self, params, tokens, rows):
        """tokens: (n, T); -> fp32 logits at positions ``rows`` (a slice)."""
        x, _ = self.hidden(params, tokens)
        h = plain.rms_norm(x[:, rows], params["embed/final_norm"].float(),
                           self.s["eps"])
        return plain.mm(h, params["embed/head"].float(), self.prec)

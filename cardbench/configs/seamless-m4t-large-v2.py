"""seamless-m4t-large-v2's plain reference: the text encoder-decoder as the
port models it (RMSNorm before each sub-layer, sinusoidal positions, no
rotary, gelu-tanh MLPs; the encoder bidirectional over the stub frame
embeddings; each decoder layer causal self-attention, cross-attention to
the encoder's output, MLP), in fp32 from the bf16 weights, through
``cbench.plain``'s blocks.

It imports nothing of the program.  Its layout is the program's param tree.
"""
from __future__ import annotations

import math

import torch

from cbench import plain

ENC = ("encoder/norm1", "encoder/attn/wq", "encoder/attn/wk",
       "encoder/attn/wv", "encoder/attn/wo", "encoder/norm2",
       "encoder/mlp/w_in", "encoder/mlp/w_out")
DEC = ("decoder/norm1", "decoder/attn/wq", "decoder/attn/wk",
       "decoder/attn/wv", "decoder/attn/wo", "decoder/norm2",
       "decoder/xattn/wq", "decoder/xattn/wk", "decoder/xattn/wv",
       "decoder/xattn/wo", "decoder/norm3", "decoder/mlp/w_in",
       "decoder/mlp/w_out")


def spec(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["decoder_attention_heads"]
    run = cfg["run"]
    return {"family": "encdec", "d_model": d,
            "enc_layers": cfg["encoder_layers"],
            "dec_layers": cfg["decoder_layers"],
            "layers": cfg["encoder_layers"] + cfg["decoder_layers"],
            "heads": H, "kv_heads": H, "head_dim": d // H,
            "d_ff": cfg["decoder_ffn_dim"], "vocab": cfg["vocab_size"],
            "padded_vocab": run["padded_vocab_size"],
            "eps": run["rms_norm_eps"], "optimizer": run["optimizer"],
            "grad_compression": run["grad_compression"],
            "remat": run["remat"]}


def layout(s: dict) -> list:
    d, ff, V = s["d_model"], s["d_ff"], s["padded_vocab"]
    n = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))
    out = [("embed/tok", (V, d), ("normal", 0.02)),
           ("embed/head", (d, V), n(d)),
           ("embed/final_norm", (d,), ("ones",))]

    def attn(stack, key, L):
        return [(f"{stack}/{key}/wq", (L, d, d), n(d)),
                (f"{stack}/{key}/wk", (L, d, d), n(d)),
                (f"{stack}/{key}/wv", (L, d, d), n(d)),
                (f"{stack}/{key}/wo", (L, d, d), n(d))]

    for stack, L in (("encoder", s["enc_layers"]),
                     ("decoder", s["dec_layers"])):
        out += [(f"{stack}/norm1", (L, d), ("ones",))] + attn(stack, "attn", L)
        out += [(f"{stack}/norm2", (L, d), ("ones",))]
        if stack == "decoder":
            out += attn(stack, "xattn", L)
            out += [("decoder/norm3", (L, d), ("ones",))]
        out += [(f"{stack}/mlp/w_in", (L, d, ff), n(d)),
                (f"{stack}/mlp/w_out", (L, ff, d), n(ff))]
    return out


def input_shapes(s: dict, B: int, S: int) -> dict:
    """A budget of S positions a row: S // 2 target tokens, the rest
    frames."""
    Sd = S // 2
    return {"tokens": ((B, Sd), "tokens"),
            "src_emb": ((B, S - Sd, s["d_model"]), "frames")}


def attention_calls(s: dict, B: int, S: int) -> list:
    Sd = S // 2
    Se = S - Sd
    H, D = s["heads"], s["head_dim"]
    return [(B, H, D, Se, Se, False, s["enc_layers"]),
            (B, H, D, Sd, Sd, True, s["dec_layers"]),
            (B, H, D, Sd, Se, False, s["dec_layers"])]


class Model:
    def __init__(self, s: dict, prec: str = "fp32"):
        self.s, self.prec = s, prec

    def _weights(self, params, names, i, grad=False):
        return {p.split("/", 1)[1]: params[p][i].detach().float()
                .requires_grad_(grad) for p in names}

    def _attn(self, W, key, x, src, causal):
        s, prec = self.s, self.prec
        B, Sq, _ = x.shape
        H, D = s["heads"], s["head_dim"]
        q = plain.mm(x, W[f"{key}/wq"], prec).view(B, Sq, H, D)
        k = plain.mm(src, W[f"{key}/wk"], prec).view(B, src.shape[1], H, D)
        v = plain.mm(src, W[f"{key}/wv"], prec).view(B, src.shape[1], H, D)
        o = plain.attention(q, k, v, causal, prec).reshape(B, Sq, H * D)
        return plain.mm(o, W[f"{key}/wo"], prec)

    def _mlp(self, W, x):
        prec = self.prec
        return plain.mm(plain.gelu_tanh(plain.mm(x, W["mlp/w_in"], prec)),
                        W["mlp/w_out"], prec)

    def enc_layer(self, W, x):
        eps = self.s["eps"]
        h = plain.rms_norm(x, W["norm1"], eps)
        x = x + self._attn(W, "attn", h, h, False)
        return x + self._mlp(W, plain.rms_norm(x, W["norm2"], eps))

    def dec_layer(self, W, x, enc):
        eps = self.s["eps"]
        h = plain.rms_norm(x, W["norm1"], eps)
        x = x + self._attn(W, "attn", h, h, True)
        x = x + self._attn(W, "xattn", plain.rms_norm(x, W["norm3"], eps),
                           enc, False)
        return x + self._mlp(W, plain.rms_norm(x, W["norm2"], eps))

    def loss_and_grads(self, params, batch):
        s = self.s
        tokens, frames = batch["tokens"], batch["src_emb"]
        dev = tokens.device
        e = frames.float() + plain.sinusoidal(frames.shape[1], s["d_model"],
                                              dev)
        x = params["embed/tok"][tokens.long()].float() + plain.sinusoidal(
            tokens.shape[1], s["d_model"], dev)
        enc_in, dec_in = [], []
        with torch.no_grad():
            for i in range(s["enc_layers"]):
                enc_in.append(e)
                e = self.enc_layer(self._weights(params, ENC, i), e)
            for i in range(s["dec_layers"]):
                dec_in.append(x)
                x = self.dec_layer(self._weights(params, DEC, i), x, e)
        loss, dx, dnorm, dhead = plain.head_backward(
            x, params["embed/final_norm"], params["embed/head"], tokens,
            s["eps"], self.prec)
        grads = {"embed/head": dhead, "embed/final_norm": dnorm}
        for p in ENC + DEC:
            grads[p] = torch.zeros(params[p].shape, dtype=torch.float32,
                                   device=dev)
        enc = e.detach().requires_grad_()
        for i in reversed(range(s["dec_layers"])):
            W = self._weights(params, DEC, i, grad=True)
            xin = dec_in[i].requires_grad_()
            with torch.enable_grad():
                y = self.dec_layer(W, xin, enc)
            y.backward(dx)
            dx = xin.grad
            dec_in[i] = None
            for p in DEC:
                grads[p][i] = W[p.split("/", 1)[1]].grad
        de = enc.grad
        for i in reversed(range(s["enc_layers"])):
            W = self._weights(params, ENC, i, grad=True)
            ein = enc_in[i].requires_grad_()
            with torch.enable_grad():
                y = self.enc_layer(W, ein)
            y.backward(de)
            de = ein.grad
            enc_in[i] = None
            for p in ENC:
                grads[p][i] = W[p.split("/", 1)[1]].grad
        dtok = torch.zeros(params["embed/tok"].shape, dtype=torch.float32,
                           device=dev)
        dtok.index_add_(0, tokens.reshape(-1).long(),
                        dx.reshape(-1, dx.shape[-1]))
        grads["embed/tok"] = dtok
        return loss, grads

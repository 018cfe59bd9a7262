"""Plain PyTorch building blocks of the reference models, and the reference
training step (loss and gradients, clipping, int8 compression, AdamW and
Adafactor).

Nothing here imports the program.  The reference computes in fp32 with
TF32 off (``exact``) and holds what the configuration stores in bf16 (the
params, Adafactor's first moment) in bf16, rounding where the configuration
rounds.  With ``prec="fp8"`` every matrix product and the attention's q, k
and v take their operands through fp8 (e4m3, one scale a tensor; the
gradients through e5m2): the control, a precision below the bf16 the
configuration states.
"""
from __future__ import annotations

import math

import torch

from .weights import STACKS, slices

FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2,
                                                     57344.0)}


def exact() -> None:
    """fp32 products in fp32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, kind: str) -> torch.Tensor:
    dtype, top = FP8[kind]
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FakeFp8(torch.autograd.Function):
    """e4m3 on the way forward, e5m2 on the way back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, "e5m2")


def fq(x: torch.Tensor, prec: str) -> torch.Tensor:
    return _FakeFp8.apply(x) if prec == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return fq(a, prec) @ fq(b, prec)


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def silu(x):
    return x * torch.sigmoid(x)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x * x * x)))


def rope(x, positions, theta: float):
    """x: (B, S, H, D); rotates the pairs (i, i + D/2), angles in fp64."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D))
    ang = positions.to(torch.float64)[:, None] * inv
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal(S: int, d: int, device):
    """The [sin, cos] position table, frequencies 10000^(-i / (d/2))."""
    pos = torch.arange(S, dtype=torch.float64, device=device)[:, None]
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float64, device=device) / half)
    return torch.cat([torch.sin(pos * freq), torch.cos(pos * freq)],
                     dim=-1).float()


class _Attention(torch.autograd.Function):
    """softmax(q k^T / sqrt(D)) v over (B, S, H, D) tensors, exact, a block
    of query rows at a time, so that no (S, Sk) matrix of all heads exists
    at once; the backward recomputes the probabilities from the saved
    log-sum-exp."""

    @staticmethod
    def _blocks(q, k):
        B, H, Sq, _ = q.shape
        rows = max(16, (1 << 27) // max(1, B * H * k.shape[2]))
        return [(i, min(i + rows, Sq)) for i in range(0, Sq, rows)]

    @staticmethod
    def _scores(q, k, i0, i1, causal, scale):
        s = (q[:, :, i0:i1] @ k.transpose(-1, -2)) * scale
        if causal:
            qi = torch.arange(i0, i1, device=q.device)[:, None]
            kj = torch.arange(k.shape[2], device=q.device)[None, :]
            s = s.masked_fill(kj > qi, float("-inf"))
        return s

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        scale = 1.0 / math.sqrt(q.shape[-1])
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=q.dtype, device=q.device)
        for i0, i1 in _Attention._blocks(q, k):
            s = _Attention._scores(q, k, i0, i1, causal, scale)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            den = p.sum(dim=-1, keepdim=True)
            out[:, :, i0:i1] = (p @ v) / den
            lse[:, :, i0:i1] = (m + torch.log(den))[..., 0]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        do = dout.transpose(1, 2)
        scale = 1.0 / math.sqrt(q.shape[-1])
        delta = (do * out).sum(dim=-1)
        dq = torch.empty_like(q)
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(v)
        for i0, i1 in _Attention._blocks(q, k):
            s = _Attention._scores(q, k, i0, i1, ctx.causal, scale)
            p = torch.exp(s - lse[:, :, i0:i1, None])
            dv += p.transpose(-1, -2) @ do[:, :, i0:i1]
            ds = p * (do[:, :, i0:i1] @ v.transpose(-1, -2)
                      - delta[:, :, i0:i1, None])
            dq[:, :, i0:i1] = (ds @ k) * scale
            dk += (ds.transpose(-1, -2) @ q[:, :, i0:i1]) * scale
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None)


def attention(q, k, v, causal: bool, prec: str):
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D), one k/v head a q head."""
    return _Attention.apply(fq(q, prec), fq(k, prec), fq(v, prec), causal)


def xent_sum(h, final_norm, head, labels, eps: float, prec: str):
    """Sum over rows of logsumexp - gold logit."""
    logits = mm(rms_norm(h, final_norm, eps), head, prec)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def head_backward(x, final_norm, head, tokens, eps: float, prec: str,
                  chunk: int = 512):
    """The next-token loss over x (B, S, d) (the last position predicts
    nothing), its gradient into x and into the final norm and the head,
    one chunk of positions at a time.  -> (loss, dx, d_norm, d_head)."""
    B, S, _ = x.shape
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    count = B * (S - 1)
    x = x.detach().requires_grad_()
    w = final_norm.detach().float().requires_grad_()
    hd = head.detach().float().requires_grad_()
    loss = 0.0
    for i in range(0, S - 1, chunk):
        j = min(i + chunk, S - 1)
        part = xent_sum(x[:, i:j], w, hd, labels[:, i:j], eps, prec) / count
        part.backward()
        loss += float(part.detach())
    return loss, x.grad, w.grad, hd.grad


# ----------------------------- the step's tail -----------------------------

GROUP = 1024
SMALL = 8 * GROUP      # leaves with fewer values are not compressed
INV_127 = torch.tensor(1.0, dtype=torch.float32) / 127.0


@torch.no_grad()
def clip_(grads: dict, clip_norm: float = 1.0) -> float:
    total = sum(float(g[i].square().sum()) for g in grads.values()
                for i in _stacked(g))
    gnorm = math.sqrt(total)
    scale = min(1.0, clip_norm / max(gnorm, 1e-9))
    for g in grads.values():
        g.mul_(scale)
    return gnorm


@torch.no_grad()
def compress_(grads: dict) -> None:
    """Each leaf of SMALL values or more through int8: groups of GROUP
    values, scale = absmax * fp32(1/127) (1 for an all-zero group), round
    half to even, clip to +-127, times the scale."""
    inv = INV_127.item()
    for g in grads.values():
        if g.numel() < SMALL:
            continue
        flat = g.view(-1)
        step = GROUP * 65536
        for i in range(0, flat.numel(), step):
            part = flat[i:i + step]
            n = part.numel()
            pad = (-n) % GROUP
            x = torch.cat([part, part.new_zeros(pad)]) if pad else part
            x = x.view(-1, GROUP)
            amax = x.abs().amax(dim=1, keepdim=True)
            scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
            q = torch.clamp(torch.round(x / scale), -127, 127)
            part.copy_((q * scale).view(-1)[:n])


def _stacked(p) -> list:
    return list(range(p.shape[0])) if p.dim() >= 3 else [Ellipsis]


def opt_init(name: str, params: dict) -> dict:
    """params: path -> bf16 leaf."""
    if name == "adamw":
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return {"count": 0, "m": {k: z(p) for k, p in params.items()},
                "v": {k: z(p) for k, p in params.items()}}
    st = {"count": 0, "vr": {}, "vc": {}, "m": {}}
    for k, p in params.items():
        fac = p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1
        st["vr"][k] = torch.zeros(p.shape[:-1] if fac else p.shape,
                                  dtype=torch.float32, device=p.device)
        st["vc"][k] = torch.zeros(p.shape[:-2] + p.shape[-1:] if fac
                                  else (1,), dtype=torch.float32,
                                  device=p.device)
        st["m"][k] = torch.zeros(p.shape, dtype=torch.bfloat16,
                                 device=p.device)
    return st


@torch.no_grad()
def opt_update_(name: str, grads: dict, st: dict, params: dict, lr=3e-4,
                b1=0.9, b2=0.95, eps=1e-8, wd=0.1, clip_rms=1.0) -> None:
    """One AdamW or Adafactor update of the bf16 params, in place: the
    arithmetic in fp32, the params rounded to bf16 (and Adafactor's first
    moment) where the configuration stores them."""
    st["count"] += 1
    c = torch.tensor(float(st["count"]), dtype=torch.float32)
    if name == "adamw":
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** c)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** c)
        for k, p in params.items():
            g, m, v = grads[k], st["m"][k], st["v"][k]
            for i in _stacked(p):
                m[i] = b1 * m[i] + (1 - b1) * g[i]
                v[i] = b2 * v[i] + (1 - b2) * g[i] * g[i]
                pf = p[i].float()
                step = (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + eps) \
                    + wd * pf
                p[i] = (pf - lr * step).to(p.dtype)
        return
    beta2 = float(1.0 - (c + 1.0) ** -0.8)
    for k, p in params.items():
        g, vr, vc, m = grads[k], st["vr"][k], st["vc"][k], st["m"][k]
        fac = p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1
        idx = _stacked(p) if fac else [Ellipsis]

        def direction(i):
            if fac:
                rfac = torch.rsqrt(vr[i] / vr[i].mean(dim=-1, keepdim=True)
                                   + 1e-30)
                cfac = torch.rsqrt(vc[i] + 1e-30)
                return g[i] * rfac[..., None] * cfac[..., None, :]
            return g[i] * torch.rsqrt(vr[i] + 1e-30)

        sq = 0.0
        for i in idx:
            g2 = g[i] * g[i] + 1e-30
            if fac:
                vr[i] = beta2 * vr[i] + (1 - beta2) * g2.mean(dim=-1)
                vc[i] = beta2 * vc[i] + (1 - beta2) * g2.mean(dim=-2)
            else:
                vr[i] = beta2 * vr[i] + (1 - beta2) * g2
            sq += float(direction(i).square().sum())
        div = max(math.sqrt(sq / p.numel() + 1e-30) / clip_rms, 1.0)
        for i in idx:
            u = direction(i) / div
            m[i] = (b1 * m[i].float() + (1 - b1) * u).to(torch.bfloat16)
            pf = p[i].float()
            p[i] = (pf - lr * (m[i].float() + wd * pf)).to(p.dtype)


def slice_norms(tree: dict, layout, stack_keys=STACKS) -> dict:
    """The norm of each part a leaf is compared by (``weights.slices``)."""
    out = {}
    for path, shape, *_ in layout:
        t = tree[path]
        for name, i in slices(path, shape, stack_keys):
            out[name] = float(torch.linalg.vector_norm(t[i].float()))
    return out


def train_reference(model, params: dict, layout, batches, steps: int,
                    optimizer: str, compression: bool,
                    stack_keys=STACKS) -> dict:
    """``steps`` reference training steps from ``params`` (path -> bf16
    leaf, updated in place) on ``batches(k)``: each step's loss, the first
    gradient as the optimizer gets it (clipped, compressed) by part."""
    st = opt_init(optimizer, params)
    losses, grad_norms = [], None
    for k in range(steps):
        loss, grads = model.loss_and_grads(params, batches(k))
        losses.append(loss)
        clip_(grads)
        if compression:
            compress_(grads)
        if k == 0:
            grad_norms = slice_norms(grads, layout, stack_keys)
        opt_update_(optimizer, grads, st, params)
        del grads
    return {"losses": losses, "grad_norms": grad_norms}

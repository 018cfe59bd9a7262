"""Optimizers over nested dicts of tensors: AdamW and Adafactor.

Counterpart of the JAX package's train/optimizer.py, with its fp32
arithmetic: the step count, ``b1 ** count`` and Adafactor's ``beta2`` are
fp32 tensors, as the reference computes them, and Adafactor keeps its first
moment in bf16 with a factored second moment.  Factoring is decided on the
stacked leaf, so a stacked norm ``(L, d)`` is factored and ``final_norm``
``(d,)`` is not, and the update-RMS clip is one mean over the whole stacked
leaf.

Unlike the JAX functions, the updates write the new params and state into
the tensors they are given (at deepseek-7b's full width a second copy of
the params alone is 13.8 GB) and return them, so the API matches.  They
work one layer of a stacked leaf at a time wherever the math allows, so an
fp32 temporary is the size of one layer, not of the stack.
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import layer_slices, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # adafactor
    decay_offset: float = 1e-3
    clip_rms: float = 1.0


def _device(params) -> torch.device:
    return next(tree_leaves(params)).device


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


# --------------------------- AdamW ---------------------------

def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}


def adamw_update(grads, state, params, oc: OptConfig):
    c = state["count"] + 1
    cf = c.float()
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - _f32(b1, cf.device) ** cf
    bc2 = 1 - _f32(b2, cf.device) ** cf

    def upd(g, m, v, p):
        for i in layer_slices(p):
            gi = g[i].float()
            m2 = b1 * m[i] + (1 - b1) * gi
            v2 = b2 * v[i] + (1 - b2) * gi * gi
            mhat = m2 / bc1
            vhat = v2 / bc2
            pf = p[i].float()
            step = mhat / (torch.sqrt(vhat) + oc.eps) + oc.weight_decay * pf
            p[i] = (pf - oc.lr * step).to(p.dtype)
            m[i] = m2
            v[i] = v2

    tree_map(upd, grads, state["m"], state["v"], params)
    state["count"] = c
    return params, state


# --------------------------- Adafactor ---------------------------

def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def adafactor_init(params) -> dict:
    def vr(p):  # row stats (reduce last dim)
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc(p):  # col stats (reduce 2nd-to-last dim)
        shape = (p.shape[:-2] + p.shape[-1:]) if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"vr": tree_map(vr, params), "vc": tree_map(vc, params),
            "m": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=p.device), params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}


def _adafactor_direction(g, vr, vc, factored):
    """The unclipped update from fp32 ``g`` and the new second moments."""
    if factored:
        rfac = torch.rsqrt(vr / vr.mean(dim=-1, keepdim=True) + 1e-30)
        cfac = torch.rsqrt(vc + 1e-30)
        return g * rfac[..., None] * cfac[..., None, :]
    return g * torch.rsqrt(vr + 1e-30)


def adafactor_update(grads, state, params, oc: OptConfig):
    c = state["count"] + 1
    beta2 = 1.0 - (c.float() + 1.0) ** -0.8

    def upd(g, vr, vc, m, p):
        fac = _factored(p)
        # A stacked leaf is cut into layers only where every reduction is
        # within a layer; the RMS clip needs the whole leaf, so its sum of
        # squares is taken in a first pass and the update made in a second.
        idx = layer_slices(p) if fac else (Ellipsis,)
        sq = torch.zeros((), dtype=torch.float32, device=p.device)
        for i in idx:
            gi = g[i].float()
            g2 = gi * gi + 1e-30
            if fac:
                vr[i] = beta2 * vr[i] + (1 - beta2) * g2.mean(dim=-1)
                vc[i] = beta2 * vc[i] + (1 - beta2) * g2.mean(dim=-2)
            else:
                vr[i] = beta2 * vr[i] + (1 - beta2) * g2
            u = _adafactor_direction(gi, vr[i], vc[i], fac)
            sq += (u * u).sum()
        rms = torch.sqrt(sq / p.numel() + 1e-30)
        div = torch.clamp(rms / oc.clip_rms, min=1.0)
        for i in idx:
            u = _adafactor_direction(g[i].float(), vr[i], vc[i], fac) / div
            m2 = (oc.b1 * m[i].float() + (1 - oc.b1) * u).to(torch.bfloat16)
            pf = p[i].float()
            step = m2.float() + oc.weight_decay * pf
            p[i] = (pf - oc.lr * step).to(p.dtype)
            m[i] = m2

    tree_map(upd, grads, state["vr"], state["vc"], state["m"], params)
    state["count"] = c
    return params, state


# --------------------------- facade ---------------------------

def opt_init(name: str, params):
    return adamw_init(params) if name == "adamw" else adafactor_init(params)


@torch.no_grad()
def opt_update(name: str, grads, state, params, oc: OptConfig | None = None):
    """Updates ``params`` and ``state`` in place and returns them."""
    oc = oc or OptConfig(name=name)
    if name == "adamw":
        return adamw_update(grads, state, params, oc)
    return adafactor_update(grads, state, params, oc)

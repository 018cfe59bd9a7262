"""Mixture-of-Experts blocks (qwen3-moe, arctic) in torch.

Counterpart of the JAX package's models/moe.py, with its routing and its
rounding steps: fp32 router logits and softmax; top-k with ties going to
the lower expert index, as ``jax.lax.top_k`` gives them (a stable
descending sort, since ``torch.topk`` promises no order); the gates
renormalised over the k choices; each choice's slot in its expert by a
cumsum over the one-hot choices flattened choice-first, so that under
capacity pressure a lower choice wins and, within one choice, the lower
token; capacity ``C`` per (group, expert), a choice past it dropped to the
dump slot ``E*C``; the expert FFN as plain batched products; the Switch
aux loss; arctic's parallel dense branch.

Dispatch and combine are gathers through the slot map where the reference
scatters: ``dispatch`` reads each slot's token row (empty slots read a zero
row), ``combine`` reads each (token, choice)'s expert output row (dropped
choices read a zero row) and sums the k gate-weighted rows of a token.
The forward is the same function and has no atomics, so it gives the same
bits on every run on CUDA.  The k gate-weighted rows of a token are summed
with fp32 accumulation and rounded to x's dtype once, where the
reference's scatter-add rounds after each add (the same numbers in fp32).

``moe_ffn`` calls the four stages (``route``, ``dispatch``,
``expert_ffn``, ``combine``) through this module's globals, so a profiler
can wrap each one in a named range without the model paying for it.
There is no mesh here: ``shard_batch``/``shard_expert`` are identities, and
``n_groups`` only cuts the tokens into groups, each with its own capacity.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers as L

Params = dict


def init_moe(gen: torch.Generator, cfg) -> Params:
    """Draws from ``gen`` on its device: the fp32 router (d, E) at scale
    0.02, the experts' w_gate / w_up (E, d, ff) and w_down (E, ff, d) in the
    config's dtype (scaled by 1/sqrt(E), their leading dim, as the
    reference's ``_init`` scales them), and arctic's dense branch."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = L._dtype(cfg)
    p = {"router": L._init(gen, (d, E), scale=0.02, dtype=torch.float32),
         "w_gate": L._init(gen, (E, d, ff), dtype=dt),
         "w_up": L._init(gen, (E, d, ff), dtype=dt),
         "w_down": L._init(gen, (E, ff, d), dtype=dt)}
    if cfg.moe_dense_ff:
        p["dense"] = L.init_mlp(gen, cfg, d_ff=cfg.moe_dense_ff)
    return p


def _capacity(tokens_per_group: int, cfg) -> int:
    c = math.ceil(tokens_per_group * cfg.experts_per_token
                  / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """Where each (group, token, choice) goes; (G, Tg, k) unless noted."""
    probs: torch.Tensor      # (G, Tg, E) fp32 router softmax
    gate: torch.Tensor       # fp32, renormalised over k, 0 where dropped
    expert: torch.Tensor     # int64 expert index, descending probability
    keep: torch.Tensor       # bool: the choice got a slot (< C)
    flat_pos: torch.Tensor   # int64 expert * C + slot, or E * C if dropped
    density: torch.Tensor    # (G, E) fp32: choices per token on each expert
    capacity: int


def router_probs(router: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """xf: (G, Tg, d) -> fp32 router softmax (G, Tg, E)."""
    return torch.softmax(xf.float() @ router, dim=-1)


def route(router: torch.Tensor, xf: torch.Tensor, k: int,
          capacity: int) -> Routing:
    """xf: (G, Tg, d) -> the routing of every token's k choices: the k
    most probable experts, a tie to the lower index."""
    probs = router_probs(router, xf)
    _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return assign(probs, idx[..., :k], capacity)


def assign(probs: torch.Tensor, expert: torch.Tensor,
           capacity: int) -> Routing:
    """Gates and slots of the choices ``expert`` (G, Tg, k), in choice
    order: the gates are their router probabilities renormalised over k,
    and each choice's slot is its rank in its expert, counted over the
    choices flattened choice-first."""
    G, Tg, k = expert.shape
    E = probs.shape[-1]
    gate = torch.gather(probs, 2, expert)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    oh = F.one_hot(expert, E)                                  # (G,Tg,k,E)
    # each expert's row of choices, choice-first, along the last dim, so
    # that the scan runs over contiguous memory (on an H100, CUDA's scan
    # along dim 1 of a (G, kTg, E) layout took 103 ms of a 160 ms qwen3-moe
    # prefill)
    oh_t = oh.permute(0, 3, 2, 1).reshape(G, E, k * Tg)
    ranks = torch.cumsum(oh_t, dim=-1) - oh_t
    slot = torch.gather(ranks, 1, expert.transpose(1, 2).reshape(
        G, 1, k * Tg)).reshape(G, k, Tg).transpose(1, 2)
    keep = slot < capacity
    return Routing(probs=probs, gate=gate * keep, expert=expert, keep=keep,
                   flat_pos=torch.where(keep, expert * capacity + slot,
                                        E * capacity),
                   density=oh.sum(2).float().mean(1), capacity=capacity)


def dispatch(xf: torch.Tensor, r: Routing) -> torch.Tensor:
    """(G, Tg, d) -> the experts' input buffers (G, E, C, d) in x's dtype:
    each slot's token row, a zero row where the slot is empty."""
    G, Tg, d = xf.shape
    E, C = r.probs.shape[-1], r.capacity
    k = r.expert.shape[-1]
    # slot -> token; Tg (the zero row) for an empty slot.  Dropped choices
    # all land on the dump slot E*C, which is cut off.
    tok = torch.full((G, E * C + 1), Tg, dtype=torch.int64, device=xf.device)
    src = torch.arange(Tg, device=xf.device).repeat_interleave(k)
    tok.scatter_(1, r.flat_pos.reshape(G, Tg * k), src.expand(G, -1))
    rows = tok[:, :E * C] + (Tg + 1) * torch.arange(
        G, device=xf.device)[:, None]
    x_pad = torch.cat([xf, xf.new_zeros((G, 1, d))], dim=1)
    return x_pad.reshape(G * (Tg + 1), d).index_select(
        0, rows.reshape(-1)).reshape(G, E, C, d)


class _ExpertFFN(torch.autograd.Function):
    """The expert FFN with the reference's hand-written backward
    (``_expert_ffn_bwd``): every product keeps E as a batch dim.  Taken
    under ``cfg.moe_expert_cvjp`` (the reference calls it refuted and keeps
    it for study)."""

    @staticmethod
    def forward(ctx, ei, wg, wu, wd):
        a = torch.einsum("gecd,edf->gecf", ei, wg)
        b = torch.einsum("gecd,edf->gecf", ei, wu)
        ctx.save_for_backward(ei, wg, wu, wd, a, b)
        return torch.einsum("gecf,efd->gecd", F.silu(a) * b, wd)

    @staticmethod
    def backward(ctx, dout):
        ei, wg, wu, wd, a, b = ctx.saved_tensors
        sig = torch.sigmoid(a.float()).to(a.dtype)
        silu_a = a * sig
        h = silu_a * b
        dh = torch.einsum("gecd,efd->gecf", dout, wd)
        dwd = torch.einsum("gecf,gecd->efd", h, dout)
        db = dh * silu_a
        da = dh * b * (sig + a * sig * (1 - sig))
        dei = (torch.einsum("gecf,edf->gecd", da, wg)
               + torch.einsum("gecf,edf->gecd", db, wu))
        dwg = torch.einsum("gecd,gecf->edf", ei, da)
        dwu = torch.einsum("gecd,gecf->edf", ei, db)
        return dei, dwg.to(wg.dtype), dwu.to(wu.dtype), dwd.to(wd.dtype)


def expert_ffn(params: Params, expert_in: torch.Tensor, cfg) -> torch.Tensor:
    """(G, E, C, d) -> (G, E, C, d): each expert's SwiGLU on its slots."""
    if cfg.moe_expert_cvjp:
        return _ExpertFFN.apply(expert_in, params["w_gate"], params["w_up"],
                                params["w_down"])
    a = torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"])
    b = torch.einsum("gecd,edf->gecf", expert_in, params["w_up"])
    return torch.einsum("gecf,efd->gecd", F.silu(a) * b, params["w_down"])


def combine(expert_out: torch.Tensor, r: Routing) -> torch.Tensor:
    """(G, E, C, d) -> (G, Tg, d): each token's k expert rows times their
    gates, summed; a dropped choice reads a zero row with gate 0."""
    G, E, C, d = expert_out.shape
    Tg, k = r.expert.shape[1:]
    out_pad = torch.cat([expert_out.reshape(G, E * C, d),
                         expert_out.new_zeros((G, 1, d))], dim=1)
    rows = r.flat_pos + (E * C + 1) * torch.arange(
        G, device=expert_out.device)[:, None, None]
    picked = out_pad.reshape(G * (E * C + 1), d).index_select(
        0, rows.reshape(-1)).reshape(G, Tg, k, d)
    weighted = picked * r.gate.to(picked.dtype)[..., None]
    return weighted.sum(dim=2, dtype=torch.float32).to(expert_out.dtype)


def moe_ffn(params: Params, x: torch.Tensor, cfg, n_groups: int = 1):
    """x: (B, S, d) -> (y (B, S, d), aux_loss fp32 scalar).

    The tokens are cut into ``n_groups`` groups (1 when that does not
    divide them), each with capacity ``_capacity(T / n_groups)``."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    G = n_groups if T % n_groups == 0 else 1
    Tg = T // G
    xf = x.reshape(G, Tg, d)
    r = route(params["router"], xf, k, _capacity(Tg, cfg))
    expert_out = expert_ffn(params, dispatch(xf, r), cfg)
    y = combine(expert_out, r).reshape(B, S, d)
    # Switch-style load-balance loss
    aux = (r.density * r.probs.mean(dim=1)).sum(-1).mean() * E
    if "dense" in params:  # arctic: parallel dense residual branch
        y = y + L.apply_mlp(params["dense"], x, cfg)
    return y, aux

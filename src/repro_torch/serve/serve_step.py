"""Serving step factories in torch: prefill (prompt -> cache) and decode
(one token).

Counterpart of the JAX package's serve/serve_step.py.  Each factory binds
the device the step runs on (the CUDA card unless ``device="cpu"``), and the
step refuses tokens that lie elsewhere rather than quietly running there.
"""
from __future__ import annotations

import torch

from ..device import require_on, resolve_device
from ..models import forward_decode, forward_prefill
from ..models import layers as L
from ..models.decode import DecodeGraphs
from ..spans import span


def make_prefill_step(cfg, pad_to: int | None = None, device=None):
    device = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        with span("serve.prefill"):
            require_on(device, batch["tokens"])
            hidden, cache = forward_prefill(params, cfg, batch,
                                            pad_to=pad_to)
            logits = L.lm_logits(params["embed"], hidden[:, -1:], cfg)
        return logits, cache
    return prefill_step


def make_decode_step(cfg, greedy: bool = True, device=None):
    """On the card an ssm_moe step replays CUDA graphs of its layers
    (``models.decode.DecodeGraphs``), captured after its first step on a
    cache."""
    device = resolve_device(device)
    graphs = DecodeGraphs() if cfg.family == "ssm_moe" else None

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        """The cache is updated in place and returned."""
        with span("serve.decode"):
            require_on(device, tokens)
            hidden, cache = forward_decode(params, cfg, cache, tokens, pos,
                                           graphs)
            logits = L.lm_logits(params["embed"], hidden, cfg)
            if greedy:
                next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None] \
                    .to(torch.int32)
            else:
                next_tok = tokens
        return next_tok, logits, cache
    return decode_step

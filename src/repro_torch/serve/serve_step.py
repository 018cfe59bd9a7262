"""Serving step factories in torch: prefill (prompt -> cache) and decode
(one token), plus the measured decode cadence.

Counterpart of the JAX package's serve/serve_step.py.  Each factory binds
the device the step runs on (the CUDA card unless ``device="cpu"``), and the
step refuses tokens that lie elsewhere rather than quietly running there.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import require_on, resolve_device
from ..models import forward_decode, forward_prefill
from ..models import layers as L


def make_prefill_step(cfg, pad_to: int | None = None, device=None):
    device = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        require_on(device, batch["tokens"])
        hidden, cache = forward_prefill(params, cfg, batch, pad_to=pad_to)
        logits = L.lm_logits(params["embed"], hidden[:, -1:])
        return logits, cache
    return prefill_step


def make_decode_step(cfg, greedy: bool = True, device=None):
    device = resolve_device(device)

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        """The cache is updated in place and returned."""
        require_on(device, tokens)
        hidden, cache = forward_decode(params, cfg, cache, tokens, pos)
        logits = L.lm_logits(params["embed"], hidden)
        if greedy:
            next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None] \
                .to(torch.int32)
        else:
            next_tok = tokens
        return next_tok, logits, cache
    return decode_step


def measure_decode_s(arch: str = "deepseek-7b", batch: int = 8,
                     prefill_len: int = 32, iters: int = 8,
                     warmup: int = 2, device=None) -> float:
    """Wall-clock seconds of one batched decode step (median over ``iters``
    after ``warmup`` runs) on the smoke variant of ``arch``.  On the card
    each step ends in ``torch.cuda.synchronize()``, so the time covers the
    device's work, not just its enqueueing.  Prefill runs once to build the
    KV cache the step consumes; every timed step decodes at the same
    position, as in the JAX package."""
    from ..configs import ARCHS, ShapeConfig, smoke_variant
    from ..models import init_model, make_inputs

    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    cfg = smoke_variant(ARCHS[arch])
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_model(gen, cfg, device=device)
    shape = ShapeConfig("serve-measure", int(prefill_len), int(batch),
                        "prefill")
    batch_in = make_inputs(gen, cfg, shape, device=device)
    _logits, cache = make_prefill_step(cfg, device=device)(params, batch_in)
    step = make_decode_step(cfg, device=device)
    tokens = batch_in["tokens"][:, -1:]
    pos = int(prefill_len)
    for _ in range(max(1, int(warmup))):
        step(params, cache, tokens, pos)
    sync()
    times = []
    for _ in range(max(1, int(iters))):
        t0 = time.perf_counter()
        step(params, cache, tokens, pos)
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))

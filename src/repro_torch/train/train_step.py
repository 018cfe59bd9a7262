"""Training step factory: loss -> grads -> clip -> (optional compression)
-> update.

Counterpart of the JAX package's train/train_step.py.
``make_train_step(cfg)`` returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
bound to one device (the CUDA card unless ``device="cpu"``).  Gradient
compression (``cfg.grad_compression``) round-trips each gradient through
the int8 quantize / dequantize kernels: the compressed form is what a
data-parallel all-reduce would ship (4x fewer bytes than fp32); on one card
its numerical effect is the whole of it.
"""
from __future__ import annotations

import torch

from ..device import require_on, resolve_device
from ..kernels import ops
from ..kernels.quantize import BLOCK_GROUPS, GROUP
from ..models import forward_train
from ..spans import span
from ..tree import layer_slices, tree_leaves, tree_map
from .loss import lm_loss
from .optimizer import OptConfig, opt_update


def _compress_leaf(g: torch.Tensor) -> torch.Tensor:
    """int8 quantize -> dequantize round trip (the all-reduce payload).
    The kernels read and write bf16 leaves as they are: the same numbers
    as widening to fp32 first and casting back after."""
    if g.numel() < GROUP * BLOCK_GROUPS:
        return g  # tiny leaves (norm scales) are not worth compressing
    return ops.dequantize(*ops.quantize(g))


@torch.no_grad()
def compress_grads(grads):
    """Every leaf through ``_compress_leaf``.  The leaves are replaced in
    ``grads``'s own dicts, one at a time, so only one leaf exists twice at
    once; the same tree is returned."""
    for k, g in grads.items():
        grads[k] = compress_grads(g) if isinstance(g, dict) \
            else _compress_leaf(g)
    return grads


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (one layer of a
    stacked leaf at a time)."""
    total = None
    for x in tree_leaves(tree):
        for i in layer_slices(x):
            s = x[i].float().square().sum()
            total = s if total is None else total + s
    return torch.sqrt(total)


def loss_and_grads(params, cfg, batch, n_groups: int = 1):
    """-> (loss, aux, grads): one forward and backward pass.  ``grads`` has
    the params' tree and dtypes; the params are left as they were found
    (no ``requires_grad``, no ``.grad``)."""
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            with span("train.forward"):
                hidden, aux = forward_train(params, cfg, batch,
                                            n_groups=n_groups)
                loss = lm_loss(params, cfg, hidden, batch["tokens"], aux)
                del hidden
            with span("train.backward"):
                loss.backward()
                grads = tree_map(lambda p: p.grad if p.grad is not None
                                 else torch.zeros_like(p), params)
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    return loss.detach(), aux.detach(), grads


def make_train_step(cfg, oc: OptConfig | None = None, n_groups: int = 1,
                    clip_norm: float = 1.0, device=None):
    """The step updates ``params`` and ``opt_state`` in place (a second
    copy of deepseek-7b's params is 13.8 GB) and returns them, so the API
    matches the JAX package's."""
    oc = oc or OptConfig(name=cfg.optimizer)
    device = resolve_device(device)

    def train_step(params, opt_state, batch):
        with span("train.step"):
            require_on(device, batch["tokens"])
            loss, aux, grads = loss_and_grads(params, cfg, batch, n_groups)
            with span("train.clip"), torch.no_grad():
                gnorm = global_norm(grads)
                scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                                    max=1.0)
                tree_map(lambda g: g.mul_(scale.to(g.dtype)), grads)
            if cfg.grad_compression:
                with span("train.compress"):
                    grads = compress_grads(grads)
            with span("train.optimizer"):
                params, opt_state = opt_update(cfg.optimizer, grads,
                                               opt_state, params, oc)
        metrics = {"loss": loss, "grad_norm": gnorm, "aux_loss": aux}
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg, n_groups: int = 1, device=None):
    device = resolve_device(device)

    @torch.no_grad()
    def eval_step(params, batch):
        require_on(device, batch["tokens"])
        hidden, aux = forward_train(params, cfg, batch, n_groups=n_groups)
        return lm_loss(params, cfg, hidden, batch["tokens"], aux)

    return eval_step

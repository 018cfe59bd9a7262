"""LM loss, chunked over the sequence so (B, S, V) logits never exist at
once.

Counterpart of the JAX package's train/loss.py: the final norm, head
product and softmax cross-entropy run per chunk of ``CHUNK`` positions
(the same divisor search), with fp32 logits, and the chunk sums are added
in order as the reference's ``lax.scan`` adds them.  Autograd keeps each
chunk's fp32 logits for the backward pass (B·S·V·4 bytes in all).
"""
from __future__ import annotations

import torch

from ..models import layers as L

CHUNK = 512


def chunked_softmax_xent(hidden: torch.Tensor, embed_params: dict,
                         labels: torch.Tensor,
                         mask: torch.Tensor | None = None,
                         chunk: int = CHUNK) -> torch.Tensor:
    """hidden: (B, S, d); labels: (B, S) integer; mask: (B, S) or None.
    Returns the mean masked token loss (fp32 scalar)."""
    B, S, d = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    c = next(cc for cc in range(min(chunk, S), 0, -1) if S % cc == 0)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, c):
        h = L.rms_norm(hidden[:, i:i + c], embed_params["final_norm"])
        logits = (h @ embed_params["head"]).float()
        lse = torch.logsumexp(logits, dim=-1)
        lab = labels[:, i:i + c].long()
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        total = total + ((lse - gold) * mask[:, i:i + c]).sum()
    return total / torch.clamp(mask.sum(), min=1.0)


def lm_loss(params: dict, cfg, hidden: torch.Tensor, tokens: torch.Tensor,
            aux: torch.Tensor, aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token loss; the last position predicts nothing."""
    if cfg.family == "vlm":
        hidden = hidden[:, cfg.n_prefix_tokens:]
    B, S = tokens.shape
    labels = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    mask = torch.cat([torch.ones((B, S - 1), dtype=torch.float32,
                                 device=tokens.device),
                      torch.zeros((B, 1), dtype=torch.float32,
                                  device=tokens.device)], dim=1)
    loss = chunked_softmax_xent(hidden, params["embed"], labels, mask)
    return loss + aux_weight * aux

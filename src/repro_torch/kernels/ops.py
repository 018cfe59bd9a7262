"""Model-facing wrappers over the port's kernels.

``flash_attention`` is the counterpart of the JAX package's
``pallas_flash_attention`` (kernels/ops.py), forward only.  The TPU wrapper
transposes to (B, n_kv, G, S, D) and zero-pads D to 128 for the TPU's
(8, 128) tiling; the Hopper kernel reads permuted views through their
strides and takes any D <= 256, so here the layout change is a free view.
"""
from __future__ import annotations

import math

from .flash_attention import flash_fwd


def flash_attention(q, k, v, n_kv: int, causal: bool = True, window: int = 0,
                    prefix: int = 0, bq: int = 256, bk: int = 512):
    """q: (B, S, Hq, D); k, v: (B, Sk, n_kv, D) -> (B, S, Hq, D).

    ``bq``/``bk`` are accepted for the JAX signature; the kernel keeps its
    own tile sizes."""
    del bq, bk
    B, S, Hq, D = q.shape
    G = Hq // n_kv
    q5 = q.reshape(B, S, n_kv, G, D).permute(0, 2, 3, 1, 4)
    out5, _ = flash_fwd(q5, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                        causal=causal, window=window, prefix=prefix,
                        scale=1.0 / math.sqrt(D))
    return out5.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)

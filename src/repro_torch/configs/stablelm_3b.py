"""stablelm-3b [dense] — 32L d2560 32H MHA(kv=32) ff6912 V50304.

Partial rotary (25%), MHA.  [hf stabilityai/stablelm-3b-4e1t family]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab_size=50304,
    rotary_pct=0.25, rope_theta=10000.0, mlp="swiglu",
)

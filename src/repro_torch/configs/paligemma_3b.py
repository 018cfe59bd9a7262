"""paligemma-3b [vlm] — 18L d2048 8H MQA(kv=1) ff16384 V257216.

Gemma-2B text backbone behind a SigLIP vision stub: ``input_specs``
supplies 256 precomputed patch embeddings as a bidirectional prefix, text
is causal (prefix-LM masking).  [arXiv:2407.07726]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216,
    n_prefix_tokens=256, mlp="geglu", rope_theta=10000.0,
)

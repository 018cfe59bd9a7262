"""recurrentgemma-9b [hybrid] — 38L d4096 16H MQA(kv=1) ff12288 V256000.

Griffin: RG-LRU recurrent blocks with a local (window 2048) MQA attention
block every 3rd layer (1 attention : 2 recurrent).  Linear recurrence +
windowed attention => sub-quadratic, runs long_500k.  [arXiv:2402.19427]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    attn_every=3, lru_width=4096, local_window=2048, conv_width=4,
    mlp="geglu", subquadratic=True,
)

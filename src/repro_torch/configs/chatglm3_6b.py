"""chatglm3-6b [dense] — 28L d4096 32H GQA(kv=2) ff13696 V65024.

RoPE applied 2D-style to half the head dim (rotary_pct=0.5), GQA with 2 KV
heads, SwiGLU FFN.  [arXiv:2406.12793; hf THUDM/chatglm3-6b]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=65024,
    rotary_pct=0.5, rope_theta=10000.0, mlp="swiglu",
)

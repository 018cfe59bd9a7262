"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H GQA(kv=4) V151936,
MoE 128e top-8, expert d_ff 1536, head_dim 128 (q-proj 8192 > d_model, per
the published config).  Adafactor for optimizer-state fit.
[hf Qwen/Qwen3-235B-A22B]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    n_experts=128, experts_per_token=8,
    mlp="swiglu", optimizer="adafactor", rope_theta=1e6,
)

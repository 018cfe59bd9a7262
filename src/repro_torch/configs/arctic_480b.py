"""arctic-480b [moe] — 35L d7168 56H GQA(kv=8) V32000, MoE 128e top-2 with a
parallel dense-residual FFN (d_ff 4864 for both).

56 q-heads are padded to 64 for 16-way TP (zero-weight pad heads — exact
math, ~14% extra attention q-path compute, recorded in the roofline).
Trains with Adafactor: Adam's 8 B/param fp32 state cannot fit 16 GB/chip at
480 B params / 256 chips.  [hf Snowflake/snowflake-arctic-base]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    n_experts=128, experts_per_token=2, moe_dense_ff=4864,
    mlp="swiglu", optimizer="adafactor",
)

"""deepseek-7b [dense] — 30L d4096 32H MHA(kv=32) ff11008 V102400.

Plain llama architecture.  [arXiv:2401.02954; hf deepseek-ai/deepseek-llm-7b]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400,
    rope_theta=10000.0, mlp="swiglu",
)

"""h2o-danube-1.8b [dense] — 24L d2560 32H GQA(kv=8) ff6912 V32000.

llama+mistral mix with sliding-window attention — the SWA window makes it
sub-quadratic, so it runs the long_500k cell.  [arXiv:2401.16818]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000,
    swa_window=4096, rope_theta=10000.0, mlp="swiglu",
    subquadratic=True,
)

"""mamba2-370m [ssm] — 48L d1024, attention-free SSD (state-space duality),
ssm_state=128, headdim=64 (=> 32 SSD heads at expand=2), V50280 (padded to
50432 for 16-way TP).  Linear-time scan => runs long_500k.
[arXiv:2405.21060]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    subquadratic=True,
)

"""granite-4.0-h-small [ssm_moe] — 40L d4096: 36 Mamba2 layers (128 heads
of 64, state 128, one group, conv 4 with bias, chunk 256, expand 2) and 4
GQA attention layers (32 q / 8 kv heads of 128, no position encoding,
softmax scale 1/128) at 5, 15, 25 and 35; every layer ends in a dropless
72-expert top-10 MoE of width 768 beside a shared SwiGLU expert of 1536.
Embedding x12, each residual branch x0.22, logits /16, RMSNorm eps 1e-5,
V100352 tied.  32.21 B params (64.4 GB in bf16).
[hf ibm-granite/granite-4.0-h-small]
"""
from .base import ModelConfig

ATTENTION_AT = (5, 15, 25, 35)

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="ssm_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab_size=100352,
    rotary_pct=0.0, nope=True, attention_multiplier=0.0078125,
    n_experts=72, experts_per_token=10, moe_dense_ff=1536,
    moe_dropless=True,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    ssm_conv_bias=True,
    layer_types=tuple("attention" if i in ATTENTION_AT else "mamba"
                      for i in range(40)),
    rms_eps=1e-5, embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, tie_embeddings=True,
)

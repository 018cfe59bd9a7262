"""seamless-m4t-large-v2 [audio] — enc-dec, 24L d1024 16H(kv=16) ff8192
V256206.

Text enc-dec backbone (24 encoder + 24 decoder layers, NLLB-style); the
audio frontend is a STUB per the brief — ``input_specs`` supplies
precomputed frame embeddings (B, S/2, d) for the encoder and S/2 target
tokens for the decoder so the cell's token budget matches seq_len.
Vocab padded 256206 -> 256256 for 16-way TP.  [arXiv:2308.11596]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=48, enc_layers=24, dec_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    mlp="gelu", rotary_pct=0.0,   # sinusoidal/learned pos in the original
)

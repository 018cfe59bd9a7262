"""Model zoo of the PyTorch port: the dense, MoE, SSM (Mamba2) and hybrid
(Griffin) decoder-only families (encdec and vlm are not ported yet)."""
from .model import (cache_spec, forward_decode, forward_prefill,
                    forward_train, init_cache, init_model, input_specs,
                    make_inputs, param_count, text_len)

__all__ = ["cache_spec", "forward_decode", "forward_prefill",
           "forward_train", "init_cache", "init_model", "input_specs",
           "make_inputs", "param_count", "text_len"]

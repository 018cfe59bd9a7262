"""Model zoo of the PyTorch port: the dense, MoE, SSM (Mamba2), hybrid
(Griffin) and prefix-LM VLM decoder-only families and the
encoder-decoder."""
from .model import (cache_spec, forward_decode, forward_prefill,
                    forward_train, init_cache, init_model, input_specs,
                    make_inputs, param_count, param_shapes, text_len)

__all__ = ["cache_spec", "forward_decode", "forward_prefill",
           "forward_train", "init_cache", "init_model", "input_specs",
           "make_inputs", "param_count", "param_shapes", "text_len"]

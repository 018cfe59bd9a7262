"""Model zoo of the PyTorch port (dense decoder-only family so far)."""
from .model import (cache_spec, forward_decode, forward_prefill,
                    forward_train, init_cache, init_model, input_specs,
                    make_inputs, param_count, text_len)

__all__ = ["cache_spec", "forward_decode", "forward_prefill",
           "forward_train", "init_cache", "init_model", "input_specs",
           "make_inputs", "param_count", "text_len"]

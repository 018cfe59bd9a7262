"""Serving steps of the PyTorch port."""
from .serve_step import (make_decode_step, make_prefill_step,
                         measure_decode_s)

__all__ = ["make_decode_step", "make_prefill_step", "measure_decode_s"]

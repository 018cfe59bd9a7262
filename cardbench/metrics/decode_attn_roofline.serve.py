"""The decode attention's (``decode_attn`` kernels) share of its bound over
the traced decode steps (``readers.decode_attn_share``)."""
from cbench import readers


def read(rec):
    return readers.decode_attn_share(rec)

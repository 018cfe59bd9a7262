"""The flash forward's share of its bound over the traced training steps."""
from cbench import readers


def read(rec):
    return readers.flash_share(rec, "fwd") if rec["kind"] == "train" else None

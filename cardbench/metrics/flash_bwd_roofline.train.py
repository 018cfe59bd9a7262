"""The flash backward pair's (dq, dk/dv and the dk/dv reduce) share of its
bound over the traced training steps."""
from cbench import readers


def read(rec):
    return readers.flash_share(rec, "bwd") if rec["kind"] == "train" else None

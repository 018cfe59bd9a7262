"""The flash forward's share of its bound in the traced round's prefill."""
from cbench import readers


def read(rec):
    return readers.flash_share(rec, "fwd") if rec["kind"] == "serve" else None

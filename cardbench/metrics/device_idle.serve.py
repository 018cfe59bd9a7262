"""The device's idle share over the traced serving sub-window (one round's
prefill and its first decode steps), in %."""
from cbench import readers


def read(rec):
    return readers.idle_share(rec) if rec["kind"] == "serve" else None

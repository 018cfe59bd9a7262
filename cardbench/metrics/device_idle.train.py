"""The device's idle share over the traced training steps: 1 - the union
of its operations' intervals over the host clock's span, in %."""
from cbench import readers


def read(rec):
    return readers.idle_share(rec) if rec["kind"] == "train" else None

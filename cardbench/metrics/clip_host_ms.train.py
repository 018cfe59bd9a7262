"""Host ms a traced training step inside the program's ``train.clip`` span
(the global norm and the scale multiply)."""
from cbench import program_spans


def read(rec):
    return program_spans.host_ms("train.clip", "train.step")

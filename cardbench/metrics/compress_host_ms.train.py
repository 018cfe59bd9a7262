"""Host ms a traced training step inside the program's ``train.compress``
span (every gradient through int8 and back)."""
from cbench import program_spans


def read(rec):
    return program_spans.host_ms("train.compress", "train.step")

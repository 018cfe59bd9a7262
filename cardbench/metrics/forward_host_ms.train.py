"""Host ms a traced training step inside the program's ``train.forward``
span (``forward_train`` and the loss)."""
from cbench import program_spans


def read(rec):
    return program_spans.host_ms("train.forward", "train.step")

"""Host ms a traced training step inside the program's ``train.optimizer``
span (the optimizer's update of params and state)."""
from cbench import program_spans


def read(rec):
    return program_spans.host_ms("train.optimizer", "train.step")

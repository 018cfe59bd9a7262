"""Host ms a traced training step inside the program's ``train.backward``
span (``loss.backward()`` and the gather of the gradients)."""
from cbench import program_spans


def read(rec):
    return program_spans.host_ms("train.backward", "train.step")

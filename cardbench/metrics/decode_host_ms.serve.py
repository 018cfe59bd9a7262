"""Host ms a traced decode step inside the program's ``serve.decode`` span
(the whole decode step)."""
from cbench import program_spans


def read(rec):
    return program_spans.host_ms("serve.decode", "serve.decode")

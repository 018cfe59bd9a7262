"""Host ms a traced prefill inside the program's ``serve.prefill`` span
(the whole prefill step)."""
from cbench import program_spans


def read(rec):
    return program_spans.host_ms("serve.prefill", "serve.prefill")

"""Host ms a traced decode step inside the program's ``decode.attention``
spans (``attention_decode``, once a layer)."""
from cbench import program_spans


def read(rec):
    return program_spans.host_ms("decode.attention", "serve.decode")

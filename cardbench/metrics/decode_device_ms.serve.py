"""Device ms a traced decode step in the kernels launched inside the
program's ``serve.decode`` span (the whole decode step, its nested spans
included; ``readers.span_device``).  Beside ``decode_host_ms.serve`` it
shows how far the host sets the decode's pace."""
from cbench import readers


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "serve" or not tr or not tr["info"]["decode_steps"]:
        return None
    got = readers.span_device(rec, "serve.decode")
    if got is None or got[1] <= 0:
        return None
    return 1e3 * got[1] / tr["info"]["decode_steps"]

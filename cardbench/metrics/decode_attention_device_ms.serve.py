"""Device ms a traced decode step in the kernels whose function names start
``decode_attn`` (the port's decode attention and the merge of its splits),
over the traced sub-window's decode steps (its one prefill launches none).
None where no such kernel ran, as in a program without that kernel."""
from cbench import readers


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "serve" or not tr or not tr["info"]["decode_steps"]:
        return None
    seconds = sum(v for k, v in tr["by_name_s"].items()
                  if readers.kernel_function(k).startswith("decode_attn"))
    if seconds <= 0:
        return None
    return 1e3 * seconds / tr["info"]["decode_steps"]

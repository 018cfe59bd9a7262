"""The prefills' model FLOPs (``counts.prefill_flops``) over the window's
host-clock seconds from admission to first token, summed over its rounds,
as a share of the H100's bf16 peak (989 TFLOP/s, at 700 W)."""
from cbench import counts


def read(rec):
    w = rec["window"]
    if rec["kind"] != "serve" or not w["rounds"]:
        return None
    return 100.0 * w["rounds"] * w["prefill_flops"] / w["prefill_seconds"] \
        / counts.BF16_FLOP_PER_S

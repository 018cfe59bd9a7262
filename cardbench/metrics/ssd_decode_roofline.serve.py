"""The Mamba2 decode step's (``ssd_decode`` kernels) share of its bound over
the traced decode steps, in %: traced decode steps x Mamba2 layers x the
bytes one call must move, at HBM's rate, over the device time of the
kernels whose function names start ``ssd_decode``.  None where no such
kernel ran.

The sizes come from the record alone (the cell's rows; from the spec the
Mamba2 layers, H = expand d / head dim, N, P and the conv width, as
``configs/granite-4.0-h-small.py`` ``_counts`` derives them).  One call
moves, each byte once: the fp32 state read and written; the conv tail read
and written; the new x, B and C and the raw dt read, y written; the conv's
taps and bias (where there is one) and the per-head dt bias, A_log and D
read.  Activations, the tail and the taps are bf16, as the cells serve
them."""
from cbench import counts, readers

ACT_BYTES = 2       # bf16
F32_BYTES = 4


def call_bytes(B: int, H: int, N: int, P: int, K: int, bias: bool) -> int:
    """The bytes one decode call of one Mamba2 layer must move."""
    C = H * P + 2 * N                       # conv channels: x, B, C
    state = 2 * F32_BYTES * B * H * N * P
    tail = 2 * ACT_BYTES * B * (K - 1) * C
    io = ACT_BYTES * B * (C + H + H * P)    # x, B, C and dt in; y out
    weights = ACT_BYTES * (K + bias) * C + F32_BYTES * 3 * H
    return state + tail + io + weights


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "serve" or not tr:
        return None
    seconds = sum(v for k, v in tr["by_name_s"].items()
                  if readers.kernel_function(k).startswith("ssd_decode"))
    steps = tr["info"]["decode_steps"]
    s = rec["spec"]
    layers = list(s.get("layer_types") or ()).count("mamba")
    if seconds <= 0 or not steps or not layers:
        return None
    H = s["ssm_expand"] * s["d_model"] // s["ssm_headdim"]
    nbytes = call_bytes(rec["mix"]["batch"], H, s["ssm_state"],
                        s["ssm_headdim"], s["conv_width"],
                        bool(s.get("ssm_conv_bias")))
    return 100.0 * steps * layers * nbytes / counts.HBM_BYTES_PER_S \
        / seconds

"""Arithmetic the per-layer readers under ``metrics/`` share."""
from __future__ import annotations

import re

from . import counts


def kernel_function(name: str) -> str:
    """A kernel's function name without its return type, namespaces and
    template arguments: ``void (anonymous namespace)::flash_fwd_wg_kernel<64,
    128>(...)`` -> ``flash_fwd_wg_kernel``."""
    head = re.split(r"[<(]", re.sub(r"^void\s+|\(anonymous namespace\)",
                                    "", name), maxsplit=1)[0]
    return head.split("::")[-1].strip()


def flash_share(rec: dict, which: str):
    """A flash pass's share of its bound, in %: the bound of every call the
    program counted in the traced sub-window (the cell's attention shapes,
    each call the mean over the cell's kinds of call), over the device time
    of the kernels whose function names start ``flash_<which>``.  None where the
    trace holds no such kernel or the program counted no call."""
    tr = rec.get("trace")
    if not tr:
        return None
    calls = tr["counters"][f"flash_{which}_calls"]
    seconds = sum(v for k, v in tr["by_name_s"].items()
                  if kernel_function(k).startswith(f"flash_{which}"))
    if not calls or seconds <= 0:
        return None
    one = counts.flash_fwd_bound if which == "fwd" else counts.flash_bwd_bound
    kinds = rec["attention_calls"]
    mean = sum(n * one(B, H, D, Sq, Sk, causal)
               for B, H, D, Sq, Sk, causal, n in kinds) \
        / sum(k[-1] for k in kinds)
    return 100.0 * calls * mean / seconds


def idle_share(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])


def train_mfu(rec):
    """Model FLOPs of the window's steps over its host-clock seconds, as a
    share of the bf16 peak, in %."""
    w = rec["window"]
    if rec["kind"] != "train" or not w["steps"]:
        return None
    return 100.0 * w["steps"] * w["step_flops"] / w["seconds"] \
        / counts.BF16_FLOP_PER_S


def elementwise_ms(rec):
    """Device ms a traced training step in the elementwise, copy/cast and
    reduce categories."""
    tr = rec.get("trace")
    if rec["kind"] != "train" or not tr:
        return None
    cats = tr["by_category_s"]
    s = sum(cats.get(c, 0.0) for c in ("elementwise_other", "copy_cast",
                                       "reduce"))
    return 1e3 * s / tr["info"]["steps"]


def span_device(rec: dict, name: str):
    """(launches, device seconds) of the traced sub-window's kernels
    launched inside the program's span ``name``, nested spans included
    (``trace.by_span``'s paths that hold it).  None where the trace holds
    no such span."""
    tr = rec.get("trace")
    if not tr or "by_span" not in tr:
        return None
    got = [v for k, v in tr["by_span"].items() if name in k.split("/")]
    if not got:
        return None
    return (sum(v["launches"] for v in got),
            sum(v["device_s"] for v in got))


def decode_attn_share(rec: dict):
    """The decode attention's share of its bound over the traced decode
    steps, in %: the bound of every call the program counted (the cell's
    batch, q and k/v heads and head size, at each traced step's position,
    ``counts.decode_attn_bound``) over the device time of the kernels
    whose function names start ``decode_attn``.  None where no such kernel
    ran, the program counted no call, or the count is not one for each
    attention call of the cell's forward (``attention_calls``: its
    attention layers) a traced decode step."""
    tr = rec.get("trace")
    if rec["kind"] != "serve" or not tr:
        return None
    steps = tr["info"]["decode_steps"]
    calls = tr["counters"].get("decode_attn_calls")
    layers = sum(k[-1] for k in rec["attention_calls"])
    seconds = sum(v for k, v in tr["by_name_s"].items()
                  if kernel_function(k).startswith("decode_attn"))
    if seconds <= 0 or not calls or calls != layers * steps:
        return None
    s, mix = rec["spec"], rec["mix"]
    P = mix["prompt_len"]
    per_layer = sum(counts.decode_attn_bound(
        mix["batch"], s["heads"], s["kv_heads"], s["head_dim"], P + j,
        mix["pad_to"]) for j in range(steps))
    return 100.0 * layers * per_layer / seconds

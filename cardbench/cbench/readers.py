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

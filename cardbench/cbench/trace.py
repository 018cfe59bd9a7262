"""The traced sub-window: ``torch.profiler`` over whole steps or rounds, and
its reduction to what the per-layer readers and the result's ``breakdown``
read.

Busy time is the union of the device's operation intervals (kernels,
copies, fills); the idle share is 1 - busy / the host clock's span of the
sub-window.  Each device operation is attributed to the innermost range
named ``cardbench.<phase>`` that the benchmark opened around its call
into the program (``by_range``), and apart from that to the program's own
spans, ``repro_torch.<span>`` (``by_span``): keyed by the path of spans
from the outermost to the innermost one that holds its launch
(``serve.decode/decode.attention``), so that each operation counts once,
in its innermost span, and a span's whole time is the sum over the paths
that hold it (``readers.span_device``).  Operations outside every range
or span go under ``other``.  An idle gap of the device is named by what
the host was doing in its middle: the innermost host event then running.
"""
from __future__ import annotations

import time
from collections import defaultdict

RANGE = "cardbench."
SPAN = "repro_torch."      # the program's spans (``repro_torch.spans``)

# the kernel categories of scripts/profile_slice.py, frozen
CATEGORIES = (
    ("flash_fwd", ("flash_fwd_",)),
    ("flash_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_",)),
    ("dequantize", ("dequantize_kernel",)),
    ("quantize", ("quantize_kernel",)),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "splitk")),
    ("reduce", ("reduce", "softmax", "argmax", "norm")),
    ("copy_cast", ("copy", "cat", "fill")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise_other"


def union(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals) -> list:
    """(start, end) of the device's idle gaps between its first and last
    operation."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def name_gaps(gap_list, cpu_events) -> dict:
    """Idle seconds by the innermost host event running in each gap's
    middle (per thread a stack of nested events; the latest started wins
    across threads)."""
    by_thread = defaultdict(list)
    for name, s, e, tid in cpu_events:
        by_thread[tid].append((s, e, name))
    stacks = {t: [] for t in by_thread}
    cursors = {t: 0 for t in by_thread}
    for evs in by_thread.values():
        evs.sort()
    out = defaultdict(float)
    for g0, g1 in sorted(gap_list):
        mid = 0.5 * (g0 + g1)
        best = None
        for t, evs in by_thread.items():
            st, i = stacks[t], cursors[t]
            while i < len(evs) and evs[i][0] <= mid:
                while st and st[-1][1] < evs[i][0]:
                    st.pop()
                st.append(evs[i])
                i += 1
            cursors[t] = i
            while st and st[-1][1] < mid:
                st.pop()
            if st and (best is None or st[-1][0] > best[0]):
                best = st[-1]
        out[best[2] if best else "python (no host op)"] += (g1 - g0) / 1e6
    return out


def range_key(event) -> str:
    """The innermost ``cardbench.`` range holding a host event, or
    ``other``."""
    p = event
    while p is not None and not p.name.startswith(RANGE):
        p = p.cpu_parent
    return p.name[len(RANGE):] if p is not None else "other"


def span_key(event) -> str:
    """The path of the program's spans holding a host event, outermost
    first, joined by ``/``; ``other`` outside every span."""
    names = []
    p = event
    while p is not None:
        if p.name.startswith(SPAN):
            names.append(p.name[len(SPAN):])
        p = p.cpu_parent
    return "/".join(reversed(names)) or "other"


def run_traced(fn) -> dict:
    """Run ``fn`` (whole steps or rounds, ending in work queued on the
    card) under the profiler; -> the record the readers take."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        info = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, cpu = [], []
    by_range = defaultdict(lambda: {"launches": 0, "device_s": 0.0})
    by_span = defaultdict(lambda: {"launches": 0, "device_s": 0.0})
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and not e.name.startswith(RANGE):
                device.append((e.name, e.time_range.start,
                               e.time_range.end))
            continue
        cpu.append((e.name, e.time_range.start, e.time_range.end, e.thread))
        if not e.kernels:
            continue
        seconds = sum(k.duration for k in e.kernels) / 1e6
        for table, key in ((by_range, range_key(e)), (by_span, span_key(e))):
            table[key]["launches"] += len(e.kernels)
            table[key]["device_s"] += seconds
    if not device:
        raise RuntimeError("the trace holds no device operation")
    intervals = [(s, e) for _, s, e in device]
    busy = union(intervals) / 1e6
    by_name, by_cat = defaultdict(float), defaultdict(float)
    for name, s, e in device:
        by_name[name] += (e - s) / 1e6
        by_cat[category(name)] += (e - s) / 1e6
    idle = name_gaps(gaps(intervals), cpu)
    top = lambda d: [[k[:160], v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"wall_s": wall, "busy_s": busy, "launches": len(device),
            "by_category_s": dict(by_cat), "by_name_s": dict(by_name),
            "by_range": dict(by_range), "by_span": dict(by_span),
            "info": info,
            "breakdown": {"device_ops": top(by_name),
                          "idle_gaps": top(idle)}}

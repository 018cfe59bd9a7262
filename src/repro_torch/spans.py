"""Named spans at the boundaries of the port's layers, on only while a
profiler runs.

    with span("train.forward"):
        ...

With no profiler running (``torch.autograd._profiler_enabled()`` false)
``span`` returns one shared do-nothing context: no ``record_function``, no
clock read, no allocation.  Entering and leaving a ``record_function``
costs over 10 us of host time even with no profiler running, the check
under 1 us, and a decode step of deepseek-7b opens 31 spans.

Under a profiler a span opens ``record_function("repro_torch." + name)``,
so it sits in the profiler's trace on the device operations' clock (the
operations launched inside it are its descendants there), and it adds to
an in-memory record under its name: entries, inclusive host seconds and
self seconds (inclusive less the time of the spans nested in it on the
same thread).  ``record()`` returns a copy of the record; ``reset()``
empties it.  A span does no tensor work and never synchronises the device.
"""
from __future__ import annotations

import threading
import time

import torch

PREFIX = "repro_torch."

_record: dict[str, dict] = {}
_lock = threading.Lock()
_stacks = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "range", "t0", "child_s")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        self.range.__enter__()
        stack = getattr(_stacks, "stack", None)
        if stack is None:
            stack = _stacks.stack = []
        stack.append(self)
        self.child_s = 0.0
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        stack = _stacks.stack
        stack.pop()
        if stack:
            stack[-1].child_s += host_s
        with _lock:
            r = _record.setdefault(self.name, {"count": 0, "host_s": 0.0,
                                               "self_s": 0.0})
            r["count"] += 1
            r["host_s"] += host_s
            r["self_s"] += host_s - self.child_s
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context that records ``name`` while a profiler runs, else none."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _On(name)


def record() -> dict[str, dict]:
    """{name: {"count", "host_s", "self_s"}} of every span entered under a
    profiler since the last ``reset()``."""
    with _lock:
        return {k: dict(v) for k, v in _record.items()}


def reset() -> None:
    with _lock:
        _record.clear()

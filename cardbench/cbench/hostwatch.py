"""What the host did while a window ran, printed on standard error beside
the run's numbers (no metric reads it): the process's CPU seconds, the
CPUs it may run on, the seconds spent in Python's garbage collector, the
card's clock and power at the close, and the pace in each quarter of the
window.  A run that is slow all through on a slower host reads differently
from one slowed by a pause or by the card's clock.
"""
from __future__ import annotations

import gc
import os
import resource
import subprocess
import time


def _gpu_clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


class Watch:
    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, None

    def _gc(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def start(self) -> None:
        self.cpu0 = _cpu_s()
        gc.callbacks.append(self._gc)
        self.t0 = time.perf_counter()

    def stop(self, marks=()) -> dict:
        """``marks``: the host times at which each unit of work (a step, a
        round) was done, for the pace by quarter."""
        wall = time.perf_counter() - self.t0
        gc.callbacks.remove(self._gc)
        out = {"wall_s": wall, "process_cpu_s": _cpu_s() - self.cpu0,
               "affinity": sorted(os.sched_getaffinity(0)),
               "gc_s": self.gc_s, "gc_collections": self.gc_n,
               "gpu": _gpu_clocks()}
        if marks and wall > 0:
            q = [0] * 4
            for t in marks:
                q[max(0, min(3, int(4 * (t - self.t0) / wall)))] += 1
            out["per_quarter"] = q
        return out

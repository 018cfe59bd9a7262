#!/usr/bin/env python3
"""Run one cell of the benchmark (``BENCHMARK.json``) on the card.

    python3 cardbench/run.py --workload seamless-m4t-large-v2.train-2x4k \
        --seed 1234 --seconds 51 --trace 0

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
then ``checks``), and each number compared beside its limit as the last
lines on standard error.  Exits non-zero with no result where there is no
CUDA card, where the program (``src/repro_torch``) is missing, or where
JAX or the JAX package was loaded.
"""
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".cache",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".cache", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, HERE)


def pin_cpus() -> None:
    """Keep the process, and every thread it starts, on two fixed CPUs (the
    second and third it may use), the same in every run.  The host-bound
    cells' pace spreads less between runs so (seamless-m4t-large-v2's
    tokens/s on an H100 machine of 8 CPUs: 3.3 % against 8.9 % unpinned,
    six runs each, interleaved)."""
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) >= 3:
        os.sched_setaffinity(0, allowed[1:3])


if __name__ == "__main__":
    pin_cpus()
    from cbench import harness
    sys.exit(harness.main(t_start=T_START))

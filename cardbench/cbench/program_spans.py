"""The second thing the benchmark takes from the program (``repro_torch``),
beside ``program.py``: the record of its own spans (``repro_torch.spans``),
which the program keeps only while a profiler runs, so only over the
traced sub-window.  A program without spans gives an empty record, and
every reading over it is None."""
from __future__ import annotations


def record() -> dict:
    """{span: {"count", "host_s", "self_s"}} as the program keeps it."""
    try:
        from repro_torch import spans
    except ImportError:
        return {}
    return spans.record()


def host_ms(name: str, per: str):
    """Host ms inside span ``name`` per entry of span ``per``: a mean over
    however many traced sub-windows the process held.  None where either
    span is missing."""
    rec = record()
    got, div = rec.get(name), rec.get(per)
    if not got or not div or not div["count"]:
        return None
    return 1e3 * got["host_s"] / div["count"]

"""The benchmark's entry logic: reads ``BENCHMARK.json``, finds the cell's
configuration, traffic mix, limits and per-layer readers by name, runs the
cell through its traffic kind's runner and prints the result line.

Every file that belongs to one configuration, mix, cell or metric sits
under ``cardbench/`` in a file of its own:

- ``configs/<config>.json``: the configuration as it is run, and
  ``configs/<config>.py``: its plain reference (``spec``, ``layout``,
  ``input_shapes``, ``attention_calls``, ``Model``, and where
  ``counts``' formulas miss the model its own ``prefill_flops`` /
  ``train_model_flops``);
- ``traffic/<traffic>.json``: the mix's parameters (``cbench.traffic``);
- ``cells/<workload>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
- ``metrics/<metric>.py``: a per-layer reader, ``read(record) -> float or
  None``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden module)."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Modules in ``sys.modules`` whose top-level name is one of FORBIDDEN,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Cell:
    """Everything one run of one workload needs, found by name."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float,
                 trace: bool, device, t_start: float, overrides=None):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}")
        self.bench, self.work = bench, cells[workload]
        here = root / "cardbench"
        name = self.work["config"]
        entry = next(c for c in bench["configs"] if c["name"] == name)
        self.cfg = json.loads((here / "configs" / f"{name}.json").read_text())
        self.refmod = load_module(here / "configs" / f"{name}.py",
                                  "cardbench_config_" + _ident(name))
        from . import traffic
        self.mix = traffic.load(here, self.work["traffic"])
        self.limits = json.loads((here / "cells" / f"{workload}.json")
                                 .read_text())["limits"]
        overrides = overrides or {}
        self.cfg = _merged(self.cfg, overrides.get("config"))
        self.mix = _merged(self.mix, overrides.get("traffic"))
        self.spec = self.refmod.spec(self.cfg)
        self.layout = self.refmod.layout(self.spec)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.phases = {}
        self.step_wrap = overrides.get("step_wrap")
        from . import program
        self.mc = program.model_config(self.cfg, self.spec,
                                       check_arch="config" not in overrides,
                                       reduced=entry["reduced"])
        program.check_layout(self.mc, self.layout)
        self.here = here

    def mark(self, phase: str) -> None:
        """Seconds since the process started, at the end of a set-up
        phase (printed on standard error)."""
        self.sync()
        self.phases[phase] = time.perf_counter() - self.t_start

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def free(self) -> None:
        """Give the card's memory that nothing holds any more back."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated())

    def check_modules(self):
        found = forbidden_modules()
        if found:
            raise Refused(f"forbidden modules loaded: {found}")

    def run(self) -> dict:
        runner = importlib.import_module(f"cbench.kind_{self.mix['kind']}")
        out = runner.run(self)
        missing = set(self.limits) - set(out["numbers"])
        if missing:
            raise ValueError(f"limits for numbers the run does not read: "
                             f"{sorted(missing)}")
        out["checks"] = {k: {"value": v, "limit": self.limits[k]}
                         for k, v in out["numbers"].items()
                         if k in self.limits}
        out["correct"] = out["failed"] == 0 and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in out["checks"].values()) and bool(out["checks"])
        return out

    def metric_names(self, section: str) -> list:
        name = self.work["name"]
        return [m for m in self.bench[section]
                if "workloads" not in m or name in m["workloads"]]

    def per_layer(self, record: dict) -> dict:
        out = {}
        for m in self.metric_names("per_layer"):
            reader = load_module(self.here / "metrics" / f"{m['name']}.py",
                                 "cardbench_metric_" + _ident(m["name"]))
            value = reader.read(record)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def _merged(base: dict, extra) -> dict:
    if not extra:
        return base
    out = dict(base)
    for k, v in extra.items():
        out[k] = _merged(base.get(k, {}), v) if isinstance(v, dict) else v
    return out


def result_line(cell: Cell, out: dict, device_info: dict) -> dict:
    """The JSON object the run prints last: end-to-end metrics with
    ``--trace 0``, per-layer ones with ``--trace 1``; the checks last."""
    if cell.trace:
        metrics = cell.per_layer(out["record"])
        tr = out["record"]["trace"]
        device_info = dict(device_info, busy_s=tr["busy_s"],
                           window_s=tr["wall_s"])
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.metric_names("end_to_end")}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": dict(device_info,
                           memory_peak_bytes=out["memory_peak_bytes"])}
    if cell.trace:
        line["breakdown"] = out["record"]["trace"]["breakdown"]
    line["card"] = card_info()
    line["checks"] = out["checks"]
    return line


def card_info() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them (a card
    set below 700 W runs slower under load)."""
    import subprocess
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        got = f"nvidia-smi: {e}"
    return {"nvidia_smi": got}


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                 "on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root / "src"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = Cell(root, args.workload, args.seed, args.seconds,
                bool(args.trace), "cuda", t_start)
    torch.cuda.init()
    cell.mark("cuda_ready")
    try:
        out = cell.run()
        cell.check_modules()
    except Refused as e:
        print(f"cardbench: {e}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    line = result_line(cell, out, info)
    extra = {k: v for k, v in out["numbers"].items() if k not in out["checks"]}
    extra["setup_phases_s"] = cell.phases
    print(json.dumps({"readings": out.get("readings"), "other": extra}),
          file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0

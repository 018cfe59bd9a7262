#!/usr/bin/env python3
"""Where the serving and training slices' time goes on the card.

    PYTHONPATH=src python3 scripts/profile_slice.py [--decode-steps 4]
    PYTHONPATH=src python3 scripts/profile_slice.py \
        --arch qwen3-moe-235b-a22b --serve-layers 8 --train-layers 2
    PYTHONPATH=src python3 scripts/profile_slice.py --arch mamba2-370m
    PYTHONPATH=src python3 scripts/profile_slice.py \
        --arch recurrentgemma-9b --train-layers 20
    PYTHONPATH=src python3 scripts/profile_slice.py \
        --arch seamless-m4t-large-v2 --optimizer adamw
    PYTHONPATH=src python3 scripts/profile_slice.py \
        --arch paligemma-3b --optimizer adamw

Builds the slices that chip_smoke.py drives (an architecture at full
width, deepseek-7b by default, bf16, random weights from a seeded
generator, ``attn_impl="flash_pallas"``, its depth cut where asked):
serving is B=4 prompts of a 1024-position budget, one prefill and a few
greedy decode steps; training is one ``make_train_step`` step (Adafactor
unless ``--optimizer`` says otherwise, int8 gradient compression, remat)
on B=2 x 4096.  A budget splits as the reference's ``text_len`` splits it:
the VLM's 256 stub patch embeddings before its tokens, the
encoder-decoder's stub frame embeddings (half) for its encoder and tokens
(half) for its decoder.  Each phase is warmed up, timed
once without the profiler, then traced with ``torch.profiler`` (CPU and
CUDA activities).  For each phase it prints one JSON line: the host-clock
wall time with and without the profiler, the device's busy time (the union
of kernel intervals) and idle share, launches, and device time by kernel
category and by kernel name.  The model's stages run inside named profiler
ranges while the script runs: ``moe_ffn``'s router, dispatch, experts and
combine; the SSD layer; the hybrid's rec layers (their fp32 gate GEMMs and
the log-depth scan in ranges of their own), local attention and MLPs; the
encoder-decoder's encoder and decoder layers, their MLPs and decode
attention; the VLM's attention and MLPs.  The line then adds the
device time of the kernels launched in each range (the innermost one: the
forward, and its recompute under remat) and of those launched by each
autograd backward node.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CATEGORIES = (
    ("flash_fwd", ("flash_fwd_",)),          # fp32 and bf16 (_tc_) kernels
    ("flash_bwd_dq", ("flash_bwd_dq_",)),     # fp32 and bf16 (_tc_) kernels
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


def busy_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


# per family: (module, function, range); each call of the function runs
# inside a profiler range named "<family>.<range>"
RANGES = {
    "moe": (("moe", "route", "router"), ("moe", "dispatch", "dispatch"),
            ("moe", "expert_ffn", "experts"), ("moe", "combine", "combine")),
    "ssm": (("ssm", "ssd_forward", "ssd"), ("ssm", "ssd_decode_step", "ssd")),
    "hybrid": (("rglru", "rglru_block", "rec"),
               ("rglru", "_rglru_coeffs", "rec_fp32_gates"),
               ("rglru", "_linear_scan_assoc", "rec_scan"),
               ("transformer", "_apply_attn_block", "local_attn"),
               ("layers", "attention_decode", "local_attn"),
               ("layers", "apply_mlp", "mlp")),
    "encdec": (("transformer", "_enc_block", "encoder"),
               ("transformer", "_cross_block", "decoder"),
               ("layers", "attention_decode", "self_attn_decode"),
               ("layers", "apply_mlp", "mlp")),
    "vlm": (("transformer", "_apply_attn_block", "attn"),
            ("layers", "attention_decode", "attn"),
            ("layers", "apply_mlp", "mlp")),
}
RANGE = tuple(f"{family}." for family in RANGES)
BACKWARD = "autograd::engine::evaluate_function: "


def watch_stages(family: str) -> None:
    """Run each of the family's stages inside a named profiler range (the
    model looks them up in their modules at every call)."""
    import importlib

    from torch.profiler import record_function
    for mod_name, fn_name, cat in RANGES.get(family, ()):
        mod = importlib.import_module(f"repro_torch.models.{mod_name}")
        fn = getattr(mod, fn_name)

        def ranged(*a, _fn=fn, _range=f"{family}.{cat}", **kw):
            with record_function(_range):
                return _fn(*a, **kw)
        setattr(mod, fn_name, ranged)


def device_ms_by_range(prof) -> dict:
    """Device ms of the kernels launched inside each stage's range (the
    innermost), and of those each autograd backward node launched (outside
    the ranges)."""
    from torch.autograd import DeviceType
    out = defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        p = e
        while p is not None and not p.name.startswith((*RANGE, BACKWARD)):
            p = p.cpu_parent
        if p is None:
            continue
        key = p.name if p.name.startswith(RANGE) \
            else "backward " + p.name[len(BACKWARD):]
        out[key] += sum(k.duration for k in e.kernels) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def summarize(phase: str, prof, wall_ms: float, plain_wall_ms: float,
              card: str) -> dict:
    from torch.autograd import DeviceType
    # kernels only: the device-side copies of the profiler ranges are not
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and not e.name.startswith(RANGE)]
    if not kernels:
        raise SystemExit("profile_slice: the trace holds no device time")
    by_name, by_cat = defaultdict(float), defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] += dur
        by_cat[category(e.name)] += dur
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": phase, "card": card,
            "wall_ms_profiled": wall_ms, "wall_ms_unprofiled": plain_wall_ms,
            "device_busy_ms": busy / 1e3,
            "device_idle_share_unprofiled": max(
                0.0, 1.0 - busy / 1e3 / plain_wall_ms),
            "kernel_launches": len(kernels),
            "device_ms_by_category": {k: v / 1e3 for k, v in
                                      sorted(by_cat.items(),
                                             key=lambda kv: -kv[1])},
            "top_kernels_ms": [[n[:120], v / 1e3] for n, v in top],
            "device_ms_by_range": device_ms_by_range(prof)}


def make_batch(cfg, gen, B: int, S: int) -> dict:
    """B rows for a budget of S positions (``make_inputs``): the tokens,
    then the VLM's patch or the encoder-decoder's frame embeddings."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import make_inputs
    return make_inputs(gen, cfg, ShapeConfig("slice", S, B, "prefill"),
                       device="cuda")


def profile_serve(params, cfg, gen, decode_steps, timed, traced, card):
    import torch
    from repro_torch.serve import make_decode_step, make_prefill_step
    batch = make_batch(cfg, gen, 4, 1024)
    # the decoder's first position, after the VLM's patches
    S = batch["tokens"].shape[1] + cfg.n_prefix_tokens
    prefill = make_prefill_step(cfg, pad_to=S + 32, device="cuda")
    decode = make_decode_step(cfg, device="cuda")

    def run_prefill():
        return prefill(params, batch)

    def run_decode(cache, tok):
        for t in range(decode_steps):
            tok, _, cache = decode(params, cache, tok, S + t)
        return cache, tok

    logits, cache = run_prefill()                       # warm-up
    tok0 = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    run_decode(cache, tok0)
    del cache

    (_, cache), plain_ms = timed(run_prefill)
    del cache
    (_, cache), wall_ms, prof = traced(run_prefill)
    print(json.dumps(summarize("prefill", prof, wall_ms, plain_ms, card)))

    _, plain_ms = timed(lambda: run_decode(cache, tok0))
    _, wall_ms, prof = traced(lambda: run_decode(cache, tok0))
    dec = summarize(f"decode x{decode_steps}", prof, wall_ms, plain_ms,
                    card)
    dec["decode_ms_per_step_unprofiled"] = plain_ms / decode_steps
    print(json.dumps(dec))
    del cache
    torch.cuda.empty_cache()


def profile_train(params, cfg, gen, timed, traced, card, optimizer):
    from repro_torch.train import make_train_step, opt_init
    cfg = dataclasses.replace(cfg, optimizer=optimizer,
                              grad_compression=True, remat=True)
    B, S = 2, 4096
    batch = make_batch(cfg, gen, B, S)
    state = opt_init(cfg.optimizer, params)
    step = make_train_step(cfg, device="cuda")
    run = lambda: step(params, state, batch)
    run()                                               # warm-up
    _, plain_ms = timed(run)
    _, wall_ms, prof = traced(run)
    print(json.dumps(summarize(f"train step ({B}x{S}, {optimizer})", prof,
                               wall_ms, plain_ms, card)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--serve-layers", type=int, default=0,
                    help="depth of the serving slice (0: the arch's own)")
    ap.add_argument("--train-layers", type=int, default=0,
                    help="depth of the training slice (0: the arch's own)")
    ap.add_argument("--optimizer", default="adafactor",
                    choices=("adafactor", "adamw"),
                    help="the training step's optimizer")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models import init_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    base = dataclasses.replace(get_arch(args.arch), attn_impl="flash_pallas")
    serve_cfg, train_cfg = (
        dataclasses.replace(base, n_layers=n or base.n_layers)
        for n in (args.serve_layers, args.train_layers))
    watch_stages(base.family)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, serve_cfg, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def traced(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out, wall_ms = timed(fn)
        return out, wall_ms, prof

    print(json.dumps({"arch": base.name, "serve_layers": serve_cfg.n_layers,
                      "train_layers": train_cfg.n_layers, "card": card}))
    profile_serve(params, serve_cfg, gen, args.decode_steps, timed, traced,
                  card)
    if train_cfg.n_layers != serve_cfg.n_layers:
        del params
        torch.cuda.empty_cache()
        params = init_model(gen, train_cfg, device="cuda")
    profile_train(params, train_cfg, gen, timed, traced, card,
                  args.optimizer)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device time of design variants of the wgmma flash-attention forward.

    python3 scripts/flash_fwd_variants.py [--out DIR] [--repeats 2]

Builds edited copies of ``src/repro_torch/kernels/csrc/flash_fwd.cu`` (one
``nvcc`` each, all started together, into ``--out``, by default
``build/fwd_variants``), loads each through ``ctypes`` and times its
wgmma route beside the committed kernel, the same library's mma.sync route
and scaled_dot_product_attention, on the same bf16 inputs, at the serving
and training shapes of the five attention families.  The variants:

- ``bk64``: k/v tiles of 64 rows (32 at D = 256) instead of 128 (64);
- ``stages3``: a ring of 3 stages at D = 64 and 128 (D = 256 does not
  fit a third);
- ``heads_fastest``: blocks in batch x head order, all heads' longest q
  tiles first (one group of every head);
- ``qtiles_fastest``: each head's q tiles in a row (groups of one head);
- ``no_turns``: the two consumer warpgroups issue their products without
  taking turns.

Each variant's output is compared with the committed kernel's (largest
|difference|).  Times are device milliseconds a launch, the profiler's sum
of the kernels' intervals over many launches (the host's time between
launches is not counted: at the smallest shapes it exceeds the kernel's),
taken in turns, the committed kernel first and last.  Prints the card's
name and power limit, then one JSON line per shape.  Needs a CUDA card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# B, S, Hq, n_kv, D, causal, window, prefix: chip_smoke.py's slices
SHAPES = {
    "deepseek_serve": (4, 1024, 32, 32, 128, True, 0, 0),
    "deepseek_train": (2, 4096, 32, 32, 128, True, 0, 0),
    "qwen3_serve": (4, 1024, 64, 4, 128, True, 0, 0),
    "qwen3_train": (2, 4096, 64, 4, 128, True, 0, 0),
    "recurrentgemma_serve": (4, 1024, 16, 1, 256, True, 2048, 0),
    "recurrentgemma_train": (2, 4096, 16, 1, 256, True, 2048, 0),
    "paligemma_serve": (4, 1024, 8, 1, 256, True, 0, 256),
    "paligemma_train": (2, 4096, 8, 1, 256, True, 0, 256),
    "seamless_serve": (4, 512, 16, 16, 64, True, 0, 0),
    "seamless_train": (2, 2048, 16, 16, 64, True, 0, 0),
    "seamless_train_bidir": (2, 2048, 16, 16, 64, False, 0, 0),
}
DISPATCH = re.compile(r"case (\d+): return launch_wg<([^>]*)>")
# variant -> (text replacements, template arguments by D, the D it runs)
ALL_D = (64, 128, 256)
VARIANTS = {
    "bk64": ((), {64: "64, 64", 128: "128, 64", 256: "256, 32"}, ALL_D),
    "stages3": ((("constexpr int WG_STAGES = 2;",
                  "constexpr int WG_STAGES = 3;"),), {}, (64, 128)),
    "heads_fastest": ((("constexpr int WG_HEAD_GROUP = 8;",
                        "constexpr int WG_HEAD_GROUP = 65536;"),), {}, ALL_D),
    "qtiles_fastest": ((("constexpr int WG_HEAD_GROUP = 8;",
                         "constexpr int WG_HEAD_GROUP = 1;"),), {}, ALL_D),
    "no_turns": ((("{ named_sync(3 + wg, 256); }", "{}"),
                  ("{ named_arrive(4 - wg, 256); }", "{}")), {}, ALL_D),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build_variants(out: Path, build) -> dict:
    """Each variant's library path (None where nvcc failed)."""
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "flash_fwd.cu").read_text()
    for header in build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    procs = {}
    for name, (edits, tiles, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        text = DISPATCH.sub(lambda m: f"case {m.group(1)}: return launch_wg<"
                            f"{tiles.get(int(m.group(1)), m.group(2))}>",
                            text)
        (out / f"fwd_{name}.cu").write_text(text)
        lib = out / f"lib{name}.so"
        cmd = [build.cuda_tool("nvcc"), *build.NVCC_FLAGS, "-o", str(lib),
               str(out / f"fwd_{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        libs[name] = lib if proc.returncode == 0 else None
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "nvcc_failed": log[-2000:]}))
    return libs


def c_fn(path):
    fn = ctypes.CDLL(str(path)).flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)] + \
        [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "fwd_variants"))
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    print(card())
    build.build_all(("flash_fwd",))
    libs = {"main": c_fn(build.library_path("flash_fwd"))}
    for name, path in build_variants(Path(args.out), build).items():
        if path is not None:
            libs[name] = c_fn(path)

    def run(fn, q5, k4, v4, mask, route):
        B, H, G, S, D = q5.shape
        out = torch.empty((B, S, H, G, D), dtype=q5.dtype,
                          device="cuda").permute(0, 2, 3, 1, 4)
        lse = torch.empty((B, H, G, S), dtype=torch.float32, device="cuda")
        dims = (ctypes.c_int64 * 6)(B, H, G, S, k4.shape[2], D)
        st = (ctypes.c_int64 * 14)(*q5.stride()[:4], *k4.stride()[:3],
                                   *v4.stride()[:3], *out.stride()[:4])
        err = fn(q5.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dims, st, 1, route, int(mask["causal"]),
                 int(mask["window"]), int(mask["prefix"]),
                 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"cudaError {err}")
        return out

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def ms(fn, iters):
        fn()
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
        return us / 1e3 / iters

    for shape, case in SHAPES.items():
        B, S, Hq, n_kv, D, causal, window, prefix = case
        mask = dict(causal=causal, window=window, prefix=prefix)
        gen = torch.Generator(device="cuda").manual_seed(12)
        q, k, v = (torch.randn((B, S, n, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (Hq, n_kv, n_kv))
        q5 = q.reshape(B, S, n_kv, Hq // n_kv, D).permute(0, 2, 3, 1, 4)
        k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        flops = 4.0 * B * Hq * D * fa.allowed_pairs(S, S, **mask)
        r = {"shape": shape, "case": case,
             "bound_ms": flops / 989e12 * 1e3}
        iters = 20 if S <= 1024 else 8
        ref = run(libs["main"], q5, k4, v4, mask, 2)
        names = ["main", *[n for n in libs
                            if n != "main" and D in VARIANTS[n][2]]]
        for rep in range(args.repeats):
            for name in [*names, "mma"]:
                fn, route = (libs["main"], 1) if name == "mma" \
                    else (libs[name], 2)
                if name not in ("main", "mma") and rep == 0:
                    got = run(fn, q5, k4, v4, mask, route)
                    r[f"{name}_maxdiff"] = float(
                        (got.float() - ref.float()).abs().max())
                t = ms(lambda: run(fn, q5, k4, v4, mask, route), iters)
                r.setdefault(f"{name}_ms", []).append(t)
        r["main_ms"].append(ms(lambda: run(libs["main"], q5, k4, v4, mask, 2),
                               iters))
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        kw = dict(enable_gqa=True) if n_kv < Hq else {}
        if window or prefix:
            kw["attn_mask"] = fa._allow(S, S, **mask, device="cuda")
        else:
            kw["is_causal"] = causal
        with torch.no_grad():
            r["sdpa_ms"] = ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, **kw), iters)
        print(json.dumps(r))
        sys.stdout.flush()
        del q, k, v, q5, k4, v4, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

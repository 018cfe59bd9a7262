#!/usr/bin/env python3
"""Device time of the bf16 flash-attention forward kernel of one checkout.

    python3 scripts/time_flash_fwd.py [--src DIR] [--repeats 3]

Imports ``repro_torch`` from ``--src`` (this checkout's ``src`` by default;
point it at another checkout's ``src`` to time that version: each checkout
builds its kernels into its own ``build/``), then times ``flash_fwd`` on
bf16 inputs at the serving shape (B=4, 32 heads, S=1024, D=128, causal)
and the training shape (B=2, 32 heads, S=4096, D=128, causal), each as the
mean of many launches between CUDA events, repeated ``--repeats`` times in
turns.  It also times a negative scale (-1/sqrt(D)) at both shapes where
the checkout takes one.  Prints the card's name and power limit, then one
JSON line.  Needs a CUDA card.  To compare two versions, run both in one
call on one card, in turns: old, new, new, old.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

SHAPES = {"serving": (4, 1024, 32, 128, 50),
          "train": (2, 4096, 32, 128, 20)}      # B, S, heads, D, launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_flash_fwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(12)
    inputs = {}
    for name, (B, S, H, D, _) in SHAPES.items():
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        inputs[name] = (q.reshape(B, S, H, 1, D).permute(0, 2, 3, 1, 4),
                        k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))

    def ms(name, scale):
        q5, k4, v4 = inputs[name]
        n = SHAPES[name][4]
        call = lambda: fa.flash_fwd(q5, k4, v4, causal=True, scale=scale)
        try:
            call()
        except ValueError:
            return None                 # this checkout refuses the scale
        call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    out = {"src": args.src, "card": card,
           "device": torch.cuda.get_device_name(0)}
    # every positive-scale reading first, so that both versions are timed
    # under the same sequence of launches
    for sign, key in ((1.0, "ms"), (-1.0, "negative_scale_ms")):
        for _ in range(args.repeats):
            for name, (_, _, _, D, _) in SHAPES.items():
                scale = None if sign > 0 else -1.0 / math.sqrt(D)
                out.setdefault(f"{name}_{key}", []).append(ms(name, scale))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

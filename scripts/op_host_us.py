#!/usr/bin/env python3
"""Host cost of the ways a ``flash_fwd`` or ``decode_attn`` call can reach
its kernel.

    PYTHONPATH=src python3 scripts/op_host_us.py [--iters 200]

Times a small bf16 ``flash_fwd`` (one head, 128 queries and keys, D = 128,
causal), where the launch is most of the work, three ways: the wrapper
itself; the port's op ``flash_fwd_op`` (a schema defined with
``torch.library.Library``, the wrapper its CPU and CUDA kernel, as the
model reaches it); and a ``torch.library.custom_op`` around the same
wrapper, the registration the port does not use.  Then a small bf16
``decode_attn`` (one row, one kv head, 64 slots, D = 128, rope on) two
ways: its wrapper and its op ``decode_attn_op``, as ``attention_decode``
reaches it.  Each is the least of two runs of ``--iters`` calls ending in
a synchronise, taken in turns.  Prints the card's name and power limit and
one JSON line of microseconds a call.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    @torch.library.custom_op(
        "op_host_us::flash_fwd", mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, float scale) -> "
               "(Tensor, Tensor)")
    def custom_op(q, k, v, scale):
        return fa.flash_fwd(q, k, v, scale=scale)

    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((1, 1, 1, 128, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn((1, 1, 128, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    scale = 128 ** -0.5
    dq = torch.randn((1, 1, 1, 128), generator=gen,
                     device="cuda").to(torch.bfloat16)
    dc = torch.randn((1, 64, 1, 128), generator=gen,
                     device="cuda").to(torch.bfloat16)
    dc2 = dc.clone()
    calls = {"wrapper": lambda: fa.flash_fwd(q, k, k, scale=scale),
             "port_op": lambda: fa.flash_fwd_op(q, k, k, True, 0, 0, scale),
             "custom_op": lambda: custom_op(q, k, k, scale),
             "decode_wrapper": lambda: da.decode_attn(
                 dq, dq, dq, dc, dc2, 40, 1.0, 1e4, False),
             "decode_port_op": lambda: da.decode_attn_op(
                 dq, dq, dq, dc, dc2, 40, 1.0, 1e4, False)}

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / args.iters

    got = {name: [] for name in calls}
    for name in (*calls, *reversed(calls)):
        got[name].append(host_us(calls[name]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(card)
    print(json.dumps({"op_host_us": {f"{n}_us": min(v)
                                     for n, v in got.items()},
                      "iters": args.iters, "card": card}))


if __name__ == "__main__":
    main()

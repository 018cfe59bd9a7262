#!/usr/bin/env python3
"""How far each bf16 attention path of the serving slice is from fp32.

    PYTHONPATH=src python3 scripts/precision_slice.py

Builds chip_smoke.py's slice (deepseek-7b at full width, bf16 weights from
seed 0 on the card, B=4 prompts of 1024 tokens drawn from the same
generator) and runs ``forward_prefill`` four ways: bf16 through the CUDA
kernel (``flash_pallas``) and through plain blockwise torch (``flash``),
and the same two with every weight upcast to fp32 (fp32 matmuls, TF32
off).  Prints one JSON line with the relative norm error of each
last-token hidden state against the fp32 blockwise run, and of the two
bf16 runs against each other.  Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("precision_slice: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.models import forward_prefill, init_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = get_arch("deepseek-7b")
    B, S = 4, 1024
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda", dtype=torch.int32)}

    def last_hidden(p, **changes):
        with torch.no_grad():
            h, cache = forward_prefill(p, dataclasses.replace(cfg, **changes),
                                       batch)
        del cache
        return h[:, -1].float()

    runs = {f"bf16_{impl}": last_hidden(params, attn_impl=impl)
            for impl in ("flash_pallas", "flash")}

    params = tree_map(lambda x: x.float(), params)
    for impl in ("flash_pallas", "flash"):
        runs[f"fp32_{impl}"] = last_hidden(params, attn_impl=impl,
                                           param_dtype="float32")
    ref = runs["fp32_flash"]
    rel = {name: float((h - ref).norm() / ref.norm())
           for name, h in runs.items() if name != "fp32_flash"}
    bf16_pair = float((runs["bf16_flash_pallas"] - runs["bf16_flash"]).norm()
                      / runs["bf16_flash"].norm())
    print(json.dumps({"rel_err_vs_fp32_flash": rel,
                      "rel_err_bf16_flash_pallas_vs_bf16_flash": bf16_pair,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""How far each bf16 training path's gradients are from fp32, per leaf.

    PYTHONPATH=src python3 scripts/grad_precision_slice.py \
        [--arch seamless-m4t-large-v2]

Builds chip_smoke.py's training slice of an architecture (full width and
depth, bf16 weights from seed 0 on the card, B=2 over a 4096-position
budget split as the reference's ``text_len`` splits it, remat) and takes
the LM loss's gradients five ways: bf16 through the CUDA kernels
(``flash_pallas``) and through plain blockwise torch (``flash``), both
again with every weight and input upcast to fp32 (TF32 off), and bf16
through the kernels with the backward's ``delta = rowsum(dO * O)`` taken
from an fp32 forward of the same q, k, v instead of the bf16 ``out`` (the
reference's wrapper and the port's take it from the bf16 ``out``).
Prints one JSON line a comparison, with the loss's relative difference
and each leaf's relative norm error against the fp32 blockwise run; for
an encoder-decoder also the root mean square of the encoder's output and
of its mean over positions.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fp32_delta_backward(ctx, dout):
    """``ops._FlashAttention.backward`` with delta from an fp32 forward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q, k, v, _out, lse = ctx.saved_tensors
    n_kv, causal, window, prefix = ctx.mask
    mask = dict(causal=causal, window=window, prefix=prefix)
    k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    o32, _ = fa.flash_fwd(ops._five_d(q.float(), n_kv), k4.float(),
                          v4.float(), **mask)
    do5 = ops._five_d(dout.contiguous(), n_kv)
    delta = (do5.float() * o32).sum(dim=-1)
    dq5, dk4, dv4 = fa.flash_bwd(ops._five_d(q, n_kv), k4, v4, do5, lse,
                                 delta, **mask)
    return (ops._four_d(dq5).to(q.dtype), dk4.permute(0, 2, 1, 3).to(k.dtype),
            dv4.permute(0, 2, 1, 3).to(v.dtype), None, None, None, None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="seamless-m4t-large-v2")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("grad_precision_slice: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, make_inputs
    from repro_torch.models import transformer as T
    from repro_torch.train import loss_and_grads
    from repro_torch.tree import tree_items, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(get_arch(args.arch), remat=True)
    B, S = 2, 4096
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg, device="cuda")
    batch = make_inputs(gen, cfg, ShapeConfig("slice", S, B, "train"),
                        device="cuda")
    widen = lambda t: t.float() if t.is_floating_point() else t
    params32, batch32 = tree_map(widen, params), {
        k: widen(v) for k, v in batch.items()}

    def grads(impl, fp32=False):
        c = dataclasses.replace(cfg, attn_impl=impl,
                                param_dtype="float32" if fp32 else
                                cfg.param_dtype)
        loss, _, g = loss_and_grads(params32 if fp32 else params, c,
                                    batch32 if fp32 else batch)
        out = float(loss), {k: v.float().cpu() for k, v in tree_items(g)}
        del g
        torch.cuda.empty_cache()
        return out

    runs = {"fp32_flash": grads("flash", True),
            "fp32_flash_pallas": grads("flash_pallas", True),
            "bf16_flash": grads("flash"),
            "bf16_flash_pallas": grads("flash_pallas")}
    backward = ops._FlashAttention.backward
    ops._FlashAttention.backward = staticmethod(fp32_delta_backward)
    try:
        runs["bf16_flash_pallas_fp32_delta"] = grads("flash_pallas")
    finally:
        ops._FlashAttention.backward = backward
    ref_loss, ref = runs.pop("fp32_flash")
    for name, (loss, g) in runs.items():
        rel = {k: float((g[k] - ref[k]).norm() / ref[k].norm()) for k in ref}
        print(json.dumps({"arch": cfg.name, "run": name,
                          "vs": "fp32_flash",
                          "loss_rel": abs(loss - ref_loss) / ref_loss,
                          "max_leaf_rel": max(rel.values()),
                          "leaf_rel": rel, "card": card}))
    if cfg.family == "encdec":
        with torch.no_grad():
            x, pos = T._encoder_input(cfg, batch["src_emb"])
            n_heads = T.params_n_heads(params, cfg)
            for i in range(cfg.enc_layers):
                x, _ = T._enc_block(T.layer(params["encoder"], i), x, cfg,
                                    pos, n_heads=n_heads)
        x = x.float()
        rms = lambda t: float(t.square().mean().sqrt())
        print(json.dumps({"arch": cfg.name, "encoder_output_rms": rms(x),
                          "mean_over_positions_rms": rms(x.mean(dim=1)),
                          "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

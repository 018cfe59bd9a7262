#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with no
result line, where there is none or where the port's sources are missing.
Phases, each fatal on failure:

1. print the card's name and power limit; build every kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain torch version on the card, in fp32
   and bf16, at the reference tests' cases and at the serving slice's shape;
3. drive the serving slice through the port's entry points at full width:
   deepseek-7b (30 layers, d 4096, bf16, random weights from a seeded
   generator on the card), ``attn_impl="flash_pallas"``, B=4 prompts of
   1024 tokens through ``make_prefill_step``, then 32 greedy
   ``make_decode_step`` steps; every launch counter is set to 0 just before
   and read just after, and the kernel must have run once per layer;
   check the outputs (finite logits, kernel path vs the plain blockwise
   path, decode at position S vs a prefill of S+1 tokens);
4. time the slice and each kernel against its bound, its plain version and
   the nearest PyTorch call.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record, and the card's line precedes that.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

SLICE_ARCH = "deepseek-7b"
SLICE_BATCH = 4
SLICE_PROMPT = 1024
SLICE_PAD = 32
SLICE_DECODE_STEPS = 32

# (B, S, Hq, n_kv, D, causal, window, prefix): the reference tests' cases,
# a ragged S, and the slice's shape (last).
KERNEL_CASES = [
    (2, 64, 4, 2, 128, True, 0, 0),
    (2, 64, 4, 2, 80, True, 0, 0),
    (2, 96, 4, 1, 128, True, 32, 0),
    (2, 64, 4, 4, 128, True, 0, 16),
    (1, 64, 4, 4, 128, False, 0, 0),
    (2, 1000, 4, 2, 128, True, 0, 0),
    (SLICE_BATCH, SLICE_PROMPT, 32, 32, 128, True, 0, 0),
]
# fp32: the reference tests' 3e-4.  bf16 inputs: the kernel computes in
# fp32 like the plain version and rounds `out` to bf16 once (2^-8
# relative), so out is held at 1e-2 and the fp32 lse at 1e-3.
TOL = {"float32": {"out": 3e-4, "lse": 3e-4},
       "bfloat16": {"out": 1e-2, "lse": 1e-3}}
# Full width, bf16, 30 layers: the kernel keeps p in fp32 where the
# blockwise path rounds it to bf16, so last-token hidden states may differ
# by bf16 noise carried through the residual stream.
HIDDEN_REL_TOL = 2e-2
# Decode at position S (ring cache, gqa in bf16) vs the last row of a
# prefill of S+1 tokens (kernel): different summation orders and roundings
# in bf16 over 30 layers.
DECODE_REL_TOL = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_qkv(case, dtype, gen):
    """q, k, v in the model's (B, S, H, D) layout and the kernel's 5-D
    views of them (strided, no copies), as ``ops.flash_attention`` makes
    them."""
    import torch
    B, S, Hq, n_kv, D = case[:5]
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, n_kv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, n_kv, D), generator=gen, device="cuda").to(dtype)
    q5 = q.reshape(B, S, n_kv, Hq // n_kv, D).permute(0, 2, 3, 1, 4)
    return (q, k, v), (q5, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(ptxas_verbose=True)
    for name, log in logs.items():
        print(f"--- nvcc {name} ---\n{log.strip()}")
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "built": sorted(logs)}))


def phase_kernels() -> float:
    """Kernel vs plain version on the card; returns the slice case's bf16
    max |out error|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(11)
    slice_err = None
    for case in KERNEL_CASES:
        causal, window, prefix = case[5:]
        for dtype in (torch.float32, torch.bfloat16):
            _, (q5, k4, v4) = make_qkv(case, dtype, gen)
            out, lse = fa.flash_fwd(q5, k4, v4, causal=causal,
                                    window=window, prefix=prefix)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_fwd_reference(
                q5.float(), k4.float(), v4.float(), causal=causal,
                window=window, prefix=prefix)
            tol = TOL[str(dtype).split(".")[1]]
            err_out = float((out.float() - ref_out).abs().max())
            err_lse = float((lse - ref_lse).abs().max())
            ok = (torch.allclose(out.float(), ref_out, rtol=tol["out"],
                                 atol=tol["out"])
                  and torch.allclose(lse, ref_lse, rtol=tol["lse"],
                                     atol=tol["lse"]))
            print(json.dumps({"kernel": "flash_fwd", "case": case,
                              "dtype": str(dtype), "max_abs_err_out": err_out,
                              "max_abs_err_lse": err_lse, "ok": ok}))
            if not ok:
                fail(f"flash_fwd disagrees with its plain version: {case} "
                     f"{dtype}")
            if case == KERNEL_CASES[-1] and dtype == torch.bfloat16:
                slice_err = err_out
    return slice_err


def phase_slice() -> dict:
    """The serving slice at full width through the port's entry points."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import forward_prefill, init_model, param_count
    from repro_torch.serve import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(get_arch(SLICE_ARCH), attn_impl="flash_pallas")
    B, S = SLICE_BATCH, SLICE_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_model(gen, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts}
    prefill = make_prefill_step(cfg, pad_to=S + SLICE_PAD, device="cuda")
    decode = make_decode_step(cfg, device="cuda")

    def greedy(logits):
        return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)

    # warm-up: library load, cuBLAS handles, allocator (not counted)
    logits, cache = prefill(params, batch)
    decode(params, cache, greedy(logits), S)
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts to 0, one prefill, greedy decode, counts read
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = fa.LAUNCHES
    tok0 = greedy(logits)
    tok = tok0
    generated = []
    t0 = time.perf_counter()
    for t in range(SLICE_DECODE_STEPS):
        tok, step_logits, cache = decode(params, cache, tok, S + t)
        if t == 0:
            decode0_logits = step_logits
        generated.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / SLICE_DECODE_STEPS
    launches = fa.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if prefill_launches != cfg.n_layers or launches != cfg.n_layers:
        fail(f"flash_fwd launches: {prefill_launches} in prefill, "
             f"{launches} in the whole run; want {cfg.n_layers} per prefill "
             "and none in decode")
    gen_tokens = torch.cat(generated, dim=1)
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(step_logits).all())
            and bool(torch.isfinite(decode0_logits).all())):
        fail("non-finite logits")
    if gen_tokens.shape != (B, SLICE_DECODE_STEPS) or \
            int(gen_tokens.min()) < 0 or \
            int(gen_tokens.max()) >= cfg.padded_vocab():
        fail(f"bad generated tokens {tuple(gen_tokens.shape)}")
    del cache

    # kernel path vs plain blockwise path: last-token hidden state
    with torch.no_grad():
        h_kernel, c = forward_prefill(params, cfg, batch, pad_to=S + SLICE_PAD)
        h_kernel = h_kernel[:, -1].float()
        del c
        h_plain, c = forward_prefill(
            params, dataclasses.replace(cfg, attn_impl="flash"), batch,
            pad_to=S + SLICE_PAD)
        h_plain = h_plain[:, -1].float()
        del c
    hidden_rel = rel_err(h_kernel, h_plain)
    if not math.isfinite(hidden_rel) or hidden_rel > HIDDEN_REL_TOL:
        fail(f"kernel-path hidden state vs blockwise: rel err {hidden_rel}")

    # prefill-then-decode identity: decode at position S == prefill of S+1
    full_logits, c = prefill(params, {"tokens": torch.cat([prompts, tok0],
                                                          dim=1)})
    del c
    decode_rel = rel_err(decode0_logits[:, -1], full_logits[:, -1])
    argmax_agree = float((greedy(decode0_logits) == greedy(full_logits))
                         .float().mean())
    if not math.isfinite(decode_rel) or decode_rel > DECODE_REL_TOL:
        fail(f"decode at S vs prefill of S+1: rel err {decode_rel}")

    return {"arch": cfg.name, "params": param_count(params),
            "dtype": cfg.param_dtype, "batch": B, "prompt": S,
            "decode_steps": SLICE_DECODE_STEPS, "init_s": init_s,
            "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": B * S / (prefill_ms / 1e3),
            "decode_ms_per_step": decode_ms,
            "decode_tokens_per_s": B / (decode_ms / 1e3),
            "peak_mem_gb": peak_gb, "flash_fwd_launches": launches,
            "hidden_rel_err_vs_blockwise": hidden_rel,
            "hidden_rel_tol": HIDDEN_REL_TOL,
            "decode_vs_prefill_rel_err": decode_rel,
            "decode_rel_tol": DECODE_REL_TOL,
            "decode_vs_prefill_argmax_agree": argmax_agree}


def phase_kernel_times() -> dict:
    """flash_fwd at the slice's shape (bf16, causal): kernel, plain version,
    scaled_dot_product_attention (timed as a yardstick only) and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    case = KERNEL_CASES[-1]
    B, S, Hq, n_kv, D = case[:5]
    gen = torch.Generator(device="cuda").manual_seed(12)
    (q, k, v), (q5, k4, v4) = make_qkv(case, torch.bfloat16, gen)
    ms = cuda_ms(lambda: fa.flash_fwd(q5, k4, v4, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: fa.flash_fwd_reference(q5, k4, v4,
                                                      causal=True), iters=5)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), iters=20)
    # the causal triangle this data needs: S(S+1)/2 scores per head, each
    # one multiply-add in q.k and one in p.v over D
    flops = 4.0 * B * Hq * D * S * (S + 1) / 2
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) \
        + 4 * B * Hq * S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes,
            "tflops_per_s": flops / (ms / 1e3) / 1e12}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port's sources are missing under {ROOT / 'src'}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))
    phase_build()
    slice_err = phase_kernels()
    slice_run = phase_slice()
    print(json.dumps({"slice": slice_run, "card": card}))
    times = phase_kernel_times()
    print(json.dumps({"kernel_times": times, "card": card}))
    record = {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": slice_run["flash_fwd_launches"],
        "max_abs_err": slice_err, "ms": times["ms"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"]}]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

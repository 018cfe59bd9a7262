#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with no
result line, where there is none or where the port's sources are missing.
Phases, each fatal on failure:

1. print the card's name and power limit; build every kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and check that the bf16 flash-attention kernels multiply on the tensor
   cores (HMMA/HGMMA instructions in their SASS);
2. hold each kernel against its plain torch version on the card: flash
   attention forward and backward in fp32 and bf16 at the reference tests'
   cases, a ragged S, D=256 and the slices' shapes, the backward fed the
   forward kernel's own ``out`` and ``lse``; quantize / dequantize
   bit for bit on a layer-sized gradient, an all-zero group and .5 ties;
   checksum and stripe pack / unpack bit for bit, the checksum also
   against ``core.integrity.checksum`` of the host bytes, up to a
   2.7 GB (> 2^31 bytes) leaf;
3. drive the serving slice through the port's entry points at full width:
   deepseek-7b (30 layers, d 4096, bf16, random weights from a seeded
   generator on the card), ``attn_impl="flash_pallas"``, B=4 prompts of
   1024 tokens through ``make_prefill_step``, then 32 greedy
   ``make_decode_step`` steps; every launch counter is set to 0 just before
   and read just after, and the kernel must have run once per layer;
   check the outputs (finite logits, kernel path vs the plain blockwise
   path, decode at position S vs a prefill of S+1 tokens);
   then offload a session's KV cache through the store and bring it back:
   a full-width, full-depth prefill of the same prompts (its 2.08 GB bf16
   cache), ``ServeScheduler.offload`` over a ``KVCacheStore`` bound to the
   card (checksums by the kernel on the card), a routed hot restore
   (multipart, verified by the kernel on the card) and a 64 KiB decode
   window of each leaf; check the restored cache and the window bit for
   bit against a copy kept on the card, 8 greedy decode steps from each,
   exact launch counts (2 checksums an offload, 2 a restore), no host
   checksum of a leaf, and the manifest checksums against
   ``integrity.checksum`` of the host bytes;
4. drive the training slice: deepseek-7b at full width and depth with
   Adafactor, int8 gradient compression, ``flash_pallas`` and remat, one
   micro-batch of B=2 x 4096 tokens; hold the kernel path's loss, grad
   norm and per-leaf gradients against the plain path's from the same
   params and batch, then run ``make_train_step`` once to warm up and 3
   timed steps with every launch counter set to 0 just before and read
   just after (exact counts per step), and check the loss falls;
5. drive the checkpointed-training slice through the port's driver
   (``launch.train.run``): deepseek-7b at full width cut to 2 layers,
   the training slice's settings, async checkpoints every 3 steps into the
   simulated store (RP_2GX, sharded) with leaf checksums from the checksum
   kernel, an injected engine + worker failure at step 7, the restore of
   step 6 onto the card and the resume to step 10; check restarts, steps,
   the falling loss, the first save's manifest checksums against
   ``integrity.checksum`` of the host bytes, the restored tree bit for bit
   against a copy taken at the step-6 save, and exact launch counts of
   every kernel over the run; then pack and unpack every leaf of that
   checkpoint through ``ops.shard_pack`` / ``ops.shard_unpack``
   (16 targets, 64 KiB cells), with exact launch counts;
6. time the slices and each kernel against its bound, its plain version and
   the nearest PyTorch call.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record, and the card's line precedes that.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
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

# The training slice: the train_4k shape's sequence, one micro-batch.
TRAIN_BATCH = 2
TRAIN_SEQ = 4096
TRAIN_TIMED_STEPS = 3
TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ, 32, 32, 128, True, 0, 0)

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
# fp32: the reference tests' 3e-4.  bf16 inputs: the tensor-core kernel
# sums exact products of the bf16 inputs in fp32, rounds p to bf16 once as
# the operand of P.V and `out` once when stored (each at most 2^-9
# relative), so out is held at 1e-2 and the fp32 lse at 1e-3.
TOL = {"float32": {"out": 3e-4, "lse": 3e-4},
       "bfloat16": {"out": 1e-2, "lse": 1e-3}}
# Backward kernels vs their plain twin (fp32 throughout).  fp32: the
# reference tests' 4e-3 for gradients (scalar fp32 kernels).  bf16: the
# tensor-core kernels sum exact products of the bf16 inputs in fp32, round
# p and ds to bf16 once as the operands of p.dO, ds.k and ds.q, and round
# dq/dk/dv once when stored (each 2^-9 relative), so each is held at 1e-2
# relative plus 1e-2 of its largest |value| (sums over up to 4096 keys
# cancel, so single elements can be far below the tensor's scale).
BWD_CASES = KERNEL_CASES[:6] + [(1, 333, 6, 3, 256, True, 100, 0),
                                TRAIN_CASE]
GRAD_TOL = {"float32": (4e-3, 4e-3), "bfloat16": (1e-2, 1e-2)}
# The elementwise limits above are loose for the late rows of a causal
# pass, whose values are one to two orders of magnitude below the first
# rows'.  So `out` and each of dq/dk/dv are also held block by block:
# the rows (queries for out and dq, keys for dk and dv) are cut into
# ROW_BLOCKS blocks, and each block's norm of the difference over the
# twin's norm must stay under the limit.  One bf16 rounding gives about
# 2^-9/sqrt(3) = 1.1e-3; the backward's roundings of p, ds and the output
# 2.4-2.7e-3 (their emulation on the CPU, tests/test_torch_flash_bwd.py);
# fp32 differs only in summation order.
ROW_BLOCKS = 8
BLOCK_REL_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
# One layer of deepseek-7b's stacked w_gate gradient, as the quantizer sees
# it in the training step: 4096 x 11008 values = 44,032 groups.
QUANT_LEAF = (4096, 11008)
# Training slice, kernel path (forward: p rounded to bf16 before P.V;
# backward: p and ds rounded to bf16 before the second-stage products,
# fp32 dq/dk/dv accumulation) vs the plain blockwise path (bf16 p before
# P.V, autograd of the online softmax), bf16 over 30 layers, from the same
# params and batch (both deterministic).
# The loss and global grad norm are held at about 10x what they read on an
# H100 80GB HBM3 at 700 W (3.2e-5 and 2.0e-4 relative); each leaf's
# gradient at 1e-1 relative (norm of the difference over the plain norm;
# read 0.011-0.035, largest for wk and wq).  A missing or wrong attention
# gradient moves the attention leaves by O(1).
TRAIN_LOSS_REL_TOL = 3e-4
TRAIN_GNORM_REL_TOL = 2e-3
TRAIN_LEAF_REL_TOL = 1e-1
# Full width, bf16, 30 layers: both paths round p to bf16 before P.V, but
# each against the running max of its own kv blocks, and they sum in other
# orders, so last-token hidden states may differ by bf16 noise carried
# through the residual stream.
HIDDEN_REL_TOL = 2e-2
# Decode at position S (ring cache, gqa in bf16) vs the last row of a
# prefill of S+1 tokens (kernel): different summation orders and roundings
# in bf16 over 30 layers.
DECODE_REL_TOL = 5e-2
# The KV-cache offload: a session of 4 decode nodes, greedy decode steps
# from the restored cache, and the decode window read from each leaf's
# tail on the routed node.
OFFLOAD_NODES = 4
OFFLOAD_DECODE_STEPS = 8
OFFLOAD_WINDOW = 64 << 10
# The storage kernels are integer functions and are held bit for bit.
# Checksum cases (bytes): empty, 1-7, each residue mod 4, a 1 MiB + 7
# buffer; then a 4-byte but not 16-byte aligned view, deepseek-7b's
# token embedding (102400 x 4096 bf16) and its stacked w_gate at full
# depth (30 x 4096 x 11008 bf16, 2,705,326,080 bytes > 2^31).
CHECKSUM_SIZES = [0, 1, 2, 3, 4, 5, 6, 7, 1001, 1002, 1003, 1004,
                  (1 << 20) + 7]
EMBED_LEAF = (102400, 4096)
BIG_LEAF = (30, 4096, 11008)
# Stripe layouts: benchmarks/run.py's 16 targets of 64 KiB cells, and 3
# targets, which leaves the embedding's 12,800 cells ragged (padded).
STRIPES = [(16, 1 << 16), (3, 1 << 16)]
# The checkpointed-training slice through the port's driver: deepseek-7b at
# full width cut to 2 layers (the simulated store keeps every replica's
# bytes in host RAM: 4.98 GB a checkpoint, 2 replicas, up to 3 steps
# alive), the training slice's settings, saves every 3 steps and an
# injected engine + worker failure at step 7: saves at 0/3/6, a restore of
# step 6, a resume to step 10 with a save at 9.
CKPT_LAYERS = 2
CKPT_STEPS = 10
CKPT_EVERY = 3
CKPT_KILL_AT = 7
# The bf16 flash-attention kernels of each library, which must multiply on
# the tensor cores: their SASS holds HMMA (mma.sync) or HGMMA (wgmma)
# instructions.
TC_KERNELS = {"flash_fwd": ("flash_fwd_tc_kernel",),
              "flash_bwd": ("flash_bwd_dq_tc_kernel",
                            "flash_bwd_dkv_tc_kernel")}


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


def row_block_rel(got, want) -> float:
    """The largest relative norm error over ROW_BLOCKS blocks of the rows
    (dim -2) of ``got`` against ``want``."""
    import torch
    return max(rel_err(g, w) for g, w in zip(
        torch.tensor_split(got, ROW_BLOCKS, dim=-2),
        torch.tensor_split(want, ROW_BLOCKS, dim=-2)))


def check_fwd(out, lse, ref_out, ref_lse, dtype) -> dict:
    """The forward kernel's ``out`` and ``lse`` against its plain version:
    the readings, with "ok" for the limits of TOL and BLOCK_REL_TOL."""
    import torch
    name = str(dtype).split(".")[1]
    tol = TOL[name]
    r = {"max_abs_err_out": float((out.float() - ref_out).abs().max()),
         "max_abs_err_lse": float((lse - ref_lse).abs().max()),
         "block_rel_err_out": row_block_rel(out, ref_out)}
    r["ok"] = (torch.allclose(out.float(), ref_out, rtol=tol["out"],
                              atol=tol["out"])
               and torch.allclose(lse, ref_lse, rtol=tol["lse"],
                                  atol=tol["lse"])
               and r["block_rel_err_out"] <= BLOCK_REL_TOL[name])
    return r


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


def sass_mma_counts(lib, names) -> dict | None:
    """The HMMA/HGMMA instruction count of each function in ``lib`` whose
    name holds one of ``names`` (every template instance), from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import build
    tool = build.cuda_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(k in m.group(1) for k in names) \
                else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(r"\bH(?:G)?MMA\b", line):
            counts[fn] += 1
    return counts


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(ptxas_verbose=True)
    for name, log in logs.items():
        print(f"--- nvcc {name} ---\n{log.strip()}")
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "built": sorted(logs)}))
    for lib, names in TC_KERNELS.items():
        counts = sass_mma_counts(build.library_path(lib), names)
        print(json.dumps({"sass_mma_instructions": counts}))
        if counts is not None and (
                any(not any(k in fn for fn in counts) for k in names)
                or not all(counts.values())):
            fail(f"a bf16 {lib} kernel has no tensor-core instruction: "
                 f"{counts}")


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
            r = check_fwd(out, lse, ref_out, ref_lse, dtype)
            print(json.dumps({"kernel": "flash_fwd", "case": case,
                              "dtype": str(dtype), **r}))
            if not r["ok"]:
                fail(f"flash_fwd disagrees with its plain version: {case} "
                     f"{dtype}")
            if case == KERNEL_CASES[-1] and dtype == torch.bfloat16:
                slice_err = r["max_abs_err_out"]
    # a negative scale at the serving shape: the bf16 kernel runs it on a
    # negated q tile with |scale|
    case = KERNEL_CASES[-1]
    scale = -1.0 / math.sqrt(case[4])
    _, (q5, k4, v4) = make_qkv(case, torch.bfloat16, gen)
    out, lse = fa.flash_fwd(q5, k4, v4, causal=True, scale=scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_fwd_reference(
        q5.float(), k4.float(), v4.float(), causal=True, scale=scale)
    r = check_fwd(out, lse, ref_out, ref_lse, torch.bfloat16)
    print(json.dumps({"kernel": "flash_fwd", "case": case, "scale": scale,
                      "dtype": str(torch.bfloat16), **r}))
    if not r["ok"]:
        fail(f"flash_fwd with a negative scale disagrees with its plain "
             f"version: {case}")
    return slice_err


def phase_bwd_kernels() -> tuple[float, float]:
    """The forward kernel, then the backward kernels fed its own ``out``
    and ``lse`` as the training step feeds them, each against its plain
    version on the card; returns the training slice case's bf16 max
    |error| of ``out`` and over dq, dk and dv.  Runs before any model is
    loaded: at that shape the plain versions hold several 4.3 GB
    (B, H, S, S) fp32 tensors."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(13)
    fwd_err = bwd_err = None
    for case in BWD_CASES:
        causal, window, prefix = case[5:]
        mask = dict(causal=causal, window=window, prefix=prefix)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            B, S, Hq, n_kv, D = case[:5]
            (q, _, _), (q5, k4, v4) = make_qkv(case, dtype, gen)
            do5 = torch.randn(q.shape, generator=gen, device="cuda") \
                .to(dtype).reshape(B, S, n_kv, Hq // n_kv, D) \
                .permute(0, 2, 3, 1, 4)
            out, lse = fa.flash_fwd(q5, k4, v4, **mask)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_fwd_reference(
                q5.float(), k4.float(), v4.float(), **mask)
            fwd = check_fwd(out, lse, ref_out, ref_lse, dtype)
            del ref_out, ref_lse
            delta = (do5.float() * out.float()).sum(-1)
            del out
            got = fa.flash_bwd(q5, k4, v4, do5, lse, delta, **mask)
            torch.cuda.synchronize()
            want = fa.flash_bwd_reference(q5.float(), k4.float(),
                                          v4.float(), do5.float(), lse,
                                          delta, **mask)
            rtol, atol = GRAD_TOL[name]
            errs, block_errs, ok = [], [], True
            for g, w in zip(got, want):
                scale = 1.0 if dtype == torch.float32 \
                    else float(w.abs().max())
                errs.append(float((g.float() - w).abs().max()))
                block_errs.append(row_block_rel(g, w))
                ok = ok and torch.allclose(g.float(), w, rtol=rtol,
                                           atol=atol * scale) \
                    and block_errs[-1] <= BLOCK_REL_TOL[name]
            print(json.dumps({"kernel": "flash_fwd then flash_bwd",
                              "case": case, "dtype": str(dtype),
                              "fwd": fwd, "max_abs_err_dq_dk_dv": errs,
                              "block_rel_err_dq_dk_dv": block_errs,
                              "ok": ok}))
            if not fwd["ok"]:
                fail(f"flash_fwd disagrees with its plain version: {case} "
                     f"{dtype}")
            if not ok:
                fail(f"flash_bwd disagrees with its plain version: {case} "
                     f"{dtype}")
            if case == TRAIN_CASE and dtype == torch.bfloat16:
                fwd_err, bwd_err = fwd["max_abs_err_out"], max(errs)
            del got, want, lse, delta
    torch.cuda.empty_cache()
    return fwd_err, bwd_err


def phase_quant_kernels() -> dict:
    """Quantize / dequantize vs their plain twins, bit for bit: one layer
    of the w_gate gradient in bf16 (as the step feeds it) and in fp32, with
    an all-zero group and a group of exact .5 ties.  Returns the largest
    |error| of each output over both input dtypes."""
    import torch
    from repro_torch.kernels import quantize as qz
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn(QUANT_LEAF, generator=gen, device="cuda") * 1e-3
    groups = x.reshape(-1, qz.GROUP)
    groups[1] = 0.0
    groups[2] = torch.randint(-126, 126, (qz.GROUP,), generator=gen,
                              device="cuda") + 0.5
    groups[2, 0] = 127.0
    errs = {"q": 0.0, "scale": 0.0, "dequantized": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        g = groups.to(dtype)
        q, sc = qz.quantize(g)
        back = qz.dequantize(q, sc, dtype)
        torch.cuda.synchronize()
        q_ref, sc_ref = qz.quantize_reference(g)
        back_ref = qz.dequantize_reference(q_ref, sc_ref, dtype)
        same = {"q": torch.equal(q, q_ref), "scale": torch.equal(sc, sc_ref),
                "dequantized": torch.equal(back.view(torch.uint8),
                                           back_ref.view(torch.uint8))}
        ties_even = torch.equal(
            q[2, 1:].float(), torch.round(groups[2, 1:].float()))
        err = {"q": float((q.float() - q_ref.float()).abs().max()),
               "scale": float((sc - sc_ref).abs().max()),
               "dequantized": float((back.float() - back_ref.float())
                                    .abs().max())}
        print(json.dumps({"kernel": "quantize/dequantize",
                          "shape": list(g.shape), "dtype": str(dtype),
                          "bit_exact": same, "max_abs_err": err,
                          "ties_to_even": ties_even,
                          "zero_group_scale": float(sc[1, 0])}))
        if not (all(same.values()) and ties_even and float(sc[1, 0]) == 1.0):
            fail(f"quantize/dequantize disagree with their plain versions "
                 f"({dtype}): {same}")
        errs = {k: max(v, err[k]) for k, v in errs.items()}
    return errs


def phase_storage_kernels(device="cuda") -> dict:
    """Checksum and stripe pack / unpack vs their plain twins, bit for bit,
    and the checksum also vs ``core.integrity.checksum`` of the host bytes.
    Returns the largest |difference| of each kernel's output."""
    import torch
    from repro_torch.core import integrity
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import ops
    from repro_torch.kernels import shard_pack as sp
    gen = torch.Generator(device=device).manual_seed(16)

    def rand_bytes(n):
        return torch.randint(0, 256, (n,), generator=gen, device=device,
                             dtype=torch.uint8)

    embed = (torch.randn(EMBED_LEAF, generator=gen, device=device) * 0.02) \
        .to(torch.bfloat16)
    buf = rand_bytes(4096 + 4)
    cases = [(f"{n} bytes", rand_bytes(n)) for n in CHECKSUM_SIZES]
    cases += [("4-byte aligned view", buf[4:]),
              ("embed/tok bf16", embed)]
    errs = {"checksum": 0, "shard_pack": 0, "shard_unpack": 0}
    for name, x in cases + [("w_gate stacked bf16", None)]:
        if x is None:       # made last and alone: 2.7 GB on the card
            del cases
            x = (torch.randn(BIG_LEAF, generator=gen, device=device)
                 .to(torch.bfloat16))
        got = ck.checksum(x)
        want = ck.checksum_reference(x)
        full = ops.checksum_array(x)
        host = ck.byte_view(x).cpu().numpy()
        want_host = integrity.checksum(host)
        err = abs((int(got) & ck.MASK32) - (int(want) & ck.MASK32))
        rec = {"kernel": "checksum", "case": name,
               "nbytes": x.numel() * x.element_size(),
               "data_ptr_mod_16": x.data_ptr() % 16,
               "kernel_vs_twin_equal": torch.equal(got, want),
               "with_length_mix": full, "integrity_checksum": want_host}
        print(json.dumps(rec))
        if not rec["kernel_vs_twin_equal"] or full != want_host:
            fail(f"checksum disagrees: {rec}")
        errs["checksum"] = max(errs["checksum"], err)
        del x, host

    u8 = ck.byte_view(embed)
    for width, cell_bytes in STRIPES:
        packed, meta = ops.shard_pack(embed, width, cell_bytes)
        cells = torch.cat(
            [u8, u8.new_zeros((-u8.numel()) % (cell_bytes * width))]) \
            .view(torch.int32).view(-1, cell_bytes // 512, sp.CELL_COLS)
        want = sp.shard_pack_reference(cells, width)
        back_cells = sp.shard_unpack(packed)
        back = ops.shard_unpack(packed, meta)
        rec = {"kernel": "shard_pack/shard_unpack", "width": width,
               "cell_bytes": cell_bytes, "n_cells": cells.shape[0],
               "padded_bytes": cells.numel() * 4 - u8.numel(),
               "pack_equal": torch.equal(packed, want),
               "unpack_equal": torch.equal(back_cells, cells),
               "round_trip_equal": torch.equal(back, u8)}
        print(json.dumps(rec))
        if not (rec["pack_equal"] and rec["unpack_equal"]
                and rec["round_trip_equal"]):
            fail(f"shard_pack / shard_unpack disagree: {rec}")
        errs["shard_pack"] = max(errs["shard_pack"], int(
            (packed.long() - want.long()).abs().max()))
        errs["shard_unpack"] = max(errs["shard_unpack"], int(
            (back_cells.long() - cells.long()).abs().max()))
        del packed, cells, want, back_cells, back
    return errs


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


def phase_serve_offload() -> dict:
    """A session's KV cache offloaded to the store and restored onto the
    card, through the port's entry points: the serving slice's prefill at
    full width and depth, ``ServeScheduler.offload`` over a
    ``KVCacheStore`` bound to the card, a routed hot restore, a decode
    window, and decode from the restored cache against decode from a copy
    kept on the card."""
    import torch
    from repro_torch.ckpt import serializer as S
    from repro_torch.configs import get_arch
    from repro_torch.core import Pool, Topology, bandwidth, integrity
    from repro_torch.core.interfaces import DFS
    from repro_torch.kernels.checksum import byte_view
    from repro_torch.models import init_model
    from repro_torch.serve import (KVCacheStore, ServeScheduler,
                                   make_decode_step, make_prefill_step)

    cfg = dataclasses.replace(get_arch(SLICE_ARCH), attn_impl="flash_pallas")
    B, S_ = SLICE_BATCH, SLICE_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (B, S_), generator=gen,
                            device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg, pad_to=S_ + SLICE_PAD, device="cuda")
    decode = make_decode_step(cfg, device="cuda")
    launches = {}
    _zero_counters()
    logits, cache = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    launches["prefill"] = _counters()
    tok0 = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    # decode writes a cache in place: the copy the restore is held against
    clone = {k: v.clone() for k, v in cache.items()}
    leaf_shape = list(cache["k"].shape)     # (layers, B, slots, n_kv, D)
    leaf_nbytes = {f"/{k}": v.numel() * v.element_size()
                   for k, v in cache.items()}
    nbytes = sum(leaf_nbytes.values())

    pool = Pool(Topology())
    dfs = DFS(pool.create_container("serve", oclass="S2"))
    store = KVCacheStore(dfs, "dfs", device="cuda")
    sched = ServeScheduler(store, nodes=range(OFFLOAD_NODES),
                           quota_bytes=2 * nbytes)
    # host checksums of a whole leaf's bytes (the store's engines checksum
    # their own records, which are far smaller)
    host_csums = []
    checksum = integrity.checksum

    def counting_checksum(data):
        n = data.nbytes if hasattr(data, "nbytes") else len(data)
        if n in leaf_nbytes.values():
            host_csums.append(n)
        return checksum(data)

    integrity.checksum = counting_checksum
    try:
        host0 = _host_gb()
        _zero_counters()
        t0 = time.perf_counter()
        with pool.sim.phase() as wph:
            evicted = sched.offload("sess0", cache, step=S_)
        offload_s = time.perf_counter() - t0
        rss = {"before": host0["rss_gb"], "after_offload": _rss_gb()}
        launches["offload"] = _counters()
        del cache
        _zero_counters()
        t0 = time.perf_counter()
        node = sched.begin("sess0")
        with pool.sim.phase() as rph:
            restored = store.restore("sess0")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rss["after_restore"] = _rss_gb()
        sched.end("sess0", node)
        launches["restore"] = _counters()
        lo = {p: max(0, n - OFFLOAD_WINDOW) for p, n in leaf_nbytes.items()}
        window = store.restore_window("sess0", min(lo.values()),
                                      max(leaf_nbytes.values()),
                                      client_node=node)
        host1 = _host_gb()
    finally:
        integrity.checksum = checksum
    off_t, res_t = store.timings

    restored_equal = sorted(restored) == sorted(clone) and all(
        torch.equal(byte_view(restored[k]), byte_view(clone[k]))
        and restored[k].device.type == "cuda" and
        restored[k].dtype == clone[k].dtype and
        restored[k].shape == clone[k].shape for k in clone)
    window_equal = sorted(window) == sorted(leaf_nbytes) and all(
        bytes(window[p]) == bytes(byte_view(clone[p[1:]])[lo[p]:]
                                  .cpu().numpy())
        for p in leaf_nbytes)
    # after the timed window: each manifest checksum (the kernel's, on the
    # card) against integrity.checksum of the host bytes
    man = store.manifest("sess0")["leaves"]
    csum_equal = sorted(man) == sorted(leaf_nbytes) and all(
        man[f"/{k}"]["csum"] == integrity.checksum(S.leaf_to_bytes(v)[0])
        for k, v in clone.items())
    # greedy decode from each (in place, so last)
    tokens = {}
    for name, c in (("restored", restored), ("clone", clone)):
        tok, out = tok0, []
        for t in range(OFFLOAD_DECODE_STEPS):
            tok, _, c = decode(params, c, tok, S_ + t)
            out.append(tok)
        tokens[name] = torch.cat(out, dim=1)
    decode_equal = torch.equal(tokens["restored"], tokens["clone"])
    del restored, clone, params
    torch.cuda.empty_cache()

    want = {"prefill": {k: 0 for k in launches["prefill"]}}
    want["prefill"]["flash_fwd"] = cfg.n_layers
    want["offload"] = {k: 0 for k in launches["offload"]}
    want["offload"]["checksum"] = len(leaf_nbytes)
    want["restore"] = dict(want["offload"])
    r = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
         "batch": B, "prompt": S_, "pad_to": S_ + SLICE_PAD,
         "leaf_shape": leaf_shape,
         "leaf_bytes": leaf_nbytes, "session_bytes": nbytes,
         "nodes": OFFLOAD_NODES, "routed_node": node, "evicted": evicted,
         "offload_s": offload_s, "offload_split": {
             k: off_t[k] for k in ("checksum_s", "to_host_s", "store_s")},
         "restore_s": restore_s, "restore_split": {
             k: res_t[k] for k in ("read_s", "to_device_s", "checksum_s")},
         "offload_modeled_s": wph.elapsed, "restore_modeled_s": rph.elapsed,
         "offload_modeled_gib_per_s": bandwidth(nbytes, wph.elapsed),
         "restore_modeled_gib_per_s": bandwidth(nbytes, rph.elapsed),
         "rss_gb": rss, "peak_rss_gb_before": host0["peak_rss_gb"],
         "peak_rss_gb_after": host1["peak_rss_gb"],
         "host_free_after": host1["free_g"],
         "launches": launches, "want_launches": want,
         "host_leaf_checksums": len(host_csums),
         "restored_equal": restored_equal, "window_equal": window_equal,
         "decode_equal": decode_equal,
         "decoded": tokens["restored"].tolist(),
         "manifest_csum_equal": csum_equal}
    if launches != want:
        fail(f"offload path launches {launches}, want {want}")
    if host_csums:
        fail(f"host checksums of offloaded leaves: {host_csums}")
    if not (restored_equal and window_equal and decode_equal and csum_equal):
        fail(f"KV-cache offload round trip: restored {restored_equal}, "
             f"window {window_equal}, decode {decode_equal}, manifest "
             f"checksums {csum_equal}")
    return r


def _counters():
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import shard_pack as sp
    return {"flash_fwd": fa.LAUNCHES, "flash_bwd_dq": fa.BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES,
            "quantize": qz.QUANT_LAUNCHES, "dequantize": qz.DEQUANT_LAUNCHES,
            "checksum": ck.CHECKSUM_LAUNCHES, "shard_pack": sp.PACK_LAUNCHES,
            "shard_unpack": sp.UNPACK_LAUNCHES}


def _zero_counters() -> None:
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import shard_pack as sp
    fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    qz.QUANT_LAUNCHES = qz.DEQUANT_LAUNCHES = 0
    ck.CHECKSUM_LAUNCHES = sp.PACK_LAUNCHES = sp.UNPACK_LAUNCHES = 0


def _rss_gb() -> float:
    """This process's resident host memory now, GB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _host_gb() -> dict:
    import resource
    out = subprocess.run(["free", "-g"], capture_output=True, text=True,
                         timeout=60).stdout
    return {"free_g": out.strip().splitlines(), "rss_gb": _rss_gb(),
            "peak_rss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6}


def phase_ckpt_train(device="cuda") -> dict:
    """The checkpointed-training slice through ``launch.train.run``: train
    steps, rolling async checkpoints with on-card checksums, an injected
    engine + worker failure, ``restore_latest`` back onto the card and the
    resume.  The driver builds its own world; this phase only watches it:
    it keeps the driver's manager, a copy on the card of the tree the last
    save before the failure was given, the first save's manifest check
    against ``integrity.checksum`` of the host bytes, and the restored
    tree's comparison with that copy."""
    import argparse
    import torch
    from repro_torch.ckpt import Checkpointer
    from repro_torch.ckpt import serializer as S
    from repro_torch.configs import get_arch
    from repro_torch.core import integrity
    from repro_torch.kernels.checksum import byte_view
    from repro_torch.launch import train as driver

    cfg = dataclasses.replace(get_arch(SLICE_ARCH), n_layers=CKPT_LAYERS,
                              attn_impl="flash_pallas", optimizer="adafactor",
                              remat=True)
    args = argparse.Namespace(
        arch=SLICE_ARCH, smoke=False, steps=CKPT_STEPS, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, vocab=cfg.vocab_size, interface="dfs", oclass="S2",
        ckpt_oclass="RP_2GX", ckpt_layout="sharded", ckpt_every=CKPT_EVERY,
        kill_at_step=CKPT_KILL_AT, grad_compression=True, servers=4,
        workers=4, corpus_tokens=(CKPT_STEPS + 2) * TRAIN_BATCH * TRAIN_SEQ,
        shard_tokens=32768, seed=0)
    last_save = (CKPT_KILL_AT - 1) // CKPT_EVERY * CKPT_EVERY
    seen = {"saves": [], "restores": [], "check_s": 0.0}

    build_world, async_save, restore = (driver.build_world,
                                        Checkpointer.async_save,
                                        Checkpointer.restore)

    def watch_world(a):
        seen["world"] = build_world(a)
        return seen["world"]

    def watch_async_save(self, step, tree, extra_meta=None):
        seen["saves"].append(step)
        if step == last_save and not seen["restores"]:
            seen["copy"] = {p: v.clone() for p, v in S.flatten_tree(tree)}
        ev = async_save(self, step, tree, extra_meta)
        if len(seen["saves"]) == 1:
            # the first save: every manifest checksum (the kernel's, on
            # the card) against integrity.checksum of the host bytes
            t0 = time.perf_counter()
            ev.wait()
            man = self.load_manifest(step)["leaves"]
            flat = S.flatten_tree(tree)
            seen["first_save"] = {
                "leaves": len(man), "paths_equal": sorted(man) == sorted(
                    p for p, _ in flat),
                "csum_equal": all(
                    man[p]["csum"] == integrity.checksum(
                        S.leaf_to_bytes(v)[0]) for p, v in flat)}
            seen["check_s"] += time.perf_counter() - t0
        return ev

    def watch_restore(self, step, template):
        tree = restore(self, step, template)
        t0 = time.perf_counter()
        flat = S.flatten_tree(tree)
        copy = seen.get("copy", {})
        seen["restores"].append({
            "step": step, "leaves": len(flat),
            "on_card": all(v.device.type == device for _, v in flat),
            "bit_equal_to_saved": step == last_save
            and sorted(copy) == sorted(p for p, _ in flat)
            and all(torch.equal(byte_view(v), byte_view(copy[p]))
                    for p, v in flat),
            "aliases_template": bool(
                {v.data_ptr() for _, v in flat}
                & {v.data_ptr() for _, v in S.flatten_tree(template)})})
        seen["check_s"] += time.perf_counter() - t0
        return tree

    driver.build_world = watch_world
    Checkpointer.async_save = watch_async_save
    Checkpointer.restore = watch_restore
    try:
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        host_before = _host_gb()
        _zero_counters()
        t0 = time.perf_counter()
        out = driver.run(args, cfg=cfg, device=device)
        run_s = time.perf_counter() - t0
        launches = _counters()
    finally:
        driver.build_world = build_world
        Checkpointer.async_save = async_save
        Checkpointer.restore = restore
    host_after = _host_gb()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 \
        if device == "cuda" else None

    mgr = seen["world"][3]
    copy = seen.pop("copy")
    n_leaves = len(copy)
    L = cfg.n_layers
    n_big = sum(1 for p, v in copy.items()
                if p.startswith("/params/") and v.numel() >= 8192)
    restored = seen["restores"][0]["step"] if seen["restores"] else None
    steps_run = CKPT_KILL_AT + CKPT_STEPS - (last_save + 1)
    saves = [s for s in range(CKPT_KILL_AT) if s % CKPT_EVERY == 0] + \
        [s for s in range(last_save + 1, CKPT_STEPS) if s % CKPT_EVERY == 0]
    want = {"flash_fwd": 2 * L * steps_run, "flash_bwd_dq": L * steps_run,
            "flash_bwd_dkv": L * steps_run, "quantize": n_big * steps_run,
            "dequantize": n_big * steps_run,
            "checksum": n_leaves * (len(saves) + 1),
            "shard_pack": 0, "shard_unpack": 0}
    timings = {}
    for t in mgr.ckpt.timings:
        rec = timings.setdefault(f"{t['op']}_{t['step']}", {})
        rec.update({k: v for k, v in t.items() if k not in ("op", "step")})
    result = {
        "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "dtype": cfg.param_dtype,
        "optimizer": cfg.optimizer, "grad_compression": True,
        "remat": cfg.remat, "attn_impl": cfg.attn_impl,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": CKPT_STEPS,
        "ckpt_every": CKPT_EVERY, "kill_at_step": CKPT_KILL_AT,
        "result": out, "run_s": run_s, "check_s": seen["check_s"],
        "saves": seen["saves"], "restores": seen["restores"],
        "first_save": seen["first_save"], "leaves": n_leaves,
        "params": sum(v.numel() for p, v in copy.items()
                      if p.startswith("/params/")),
        "checkpoint_bytes": sum(v.numel() * v.element_size()
                                for v in copy.values()),
        "launches": launches, "want_launches": want, "timings": timings,
        "peak_mem_gb": peak_gb, "host_before": host_before,
        "host_after": host_after}
    print(json.dumps({"ckpt_train": result}))
    if out["restarts"] != 1 or out["steps"] != CKPT_STEPS:
        fail(f"driver: restarts {out['restarts']}, steps {out['steps']}; "
             f"want 1 and {CKPT_STEPS}")
    if not (math.isfinite(out["first_loss"]) and
            math.isfinite(out["final_loss"]) and
            out["final_loss"] < out["first_loss"]):
        fail(f"loss did not fall: {out['first_loss']} -> "
             f"{out['final_loss']}")
    if restored != last_save or len(seen["restores"]) != 1 or not all(
            (r["on_card"], r["bit_equal_to_saved"],
             not r["aliases_template"]) for r in seen["restores"]):
        fail(f"restore: {seen['restores']}")
    if seen["saves"] != saves:
        fail(f"saves at {seen['saves']}, want {saves}")
    fs = seen["first_save"]
    if not (fs["paths_equal"] and fs["csum_equal"]):
        fail(f"first save's manifest checksums: {fs}")
    if device == "cuda" and launches != want:
        fail(f"checkpointed training launches {launches}, want {want}")
    result["copy"] = copy       # the step-6 tree, for the stripe path
    return result


def phase_stripe(tree: dict) -> dict:
    """The stripe entry points over a checkpoint on the card: every leaf of
    the tree packed into benchmarks/run.py's layout (16 targets, 64 KiB
    cells) with ``ops.shard_pack``, unpacked with ``ops.shard_unpack`` and
    held against its own bytes, with every launch counter set to 0 just
    before and read just after."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.checksum import byte_view
    width, cell_bytes = STRIPES[0]
    _zero_counters()
    equal = True
    t0 = time.perf_counter()
    for _, leaf in sorted(tree.items()):
        packed, meta = ops.shard_pack(leaf, width, cell_bytes)
        equal = equal and torch.equal(ops.shard_unpack(packed, meta),
                                      byte_view(leaf))
        del packed
    torch.cuda.synchronize()
    launches = _counters()
    want = {k: 0 for k in launches}
    want["shard_pack"] = want["shard_unpack"] = len(tree)
    r = {"leaves": len(tree), "width": width, "cell_bytes": cell_bytes,
         "round_trip_equal": equal, "s": time.perf_counter() - t0,
         "launches": launches}
    print(json.dumps({"stripe_path": r}))
    if not equal:
        fail("stripe pack / unpack of the checkpoint did not round-trip")
    if launches != want:
        fail(f"stripe path launches {launches}, want {want}")
    return r


def train_model_flops(cfg, n_params: int) -> float:
    """Model FLOPs of one training step (no recompute): 6 per matmul weight
    per token (the token-embedding lookup is no product), plus the causal
    attention products, 4 B H D S(S+1)/2 per layer forward, x3 with the
    backward."""
    B, S = TRAIN_BATCH, TRAIN_SEQ
    dense = 6.0 * (n_params - cfg.padded_vocab() * cfg.d_model) * B * S
    attn = 3.0 * cfg.n_layers * 4.0 * B * cfg.n_heads * cfg.head_dim \
        * S * (S + 1) / 2
    return dense + attn


def phase_train() -> dict:
    """The training slice at full width through ``make_train_step``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_model, param_count
    from repro_torch.train import (global_norm, loss_and_grads,
                                   make_eval_step, make_train_step, opt_init)
    from repro_torch.tree import tree_items

    cfg = dataclasses.replace(get_arch(SLICE_ARCH), attn_impl="flash_pallas",
                              optimizer="adafactor", grad_compression=True,
                              remat=True)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    n_params = param_count(params)

    # kernel path vs plain path, same params and batch.  The kernel path's
    # grads wait on the host while the plain path runs.
    loss_k, _, grads = loss_and_grads(params, cfg, batch)
    gnorm_k = float(global_norm(grads))
    grads_k = {name: g.cpu() for name, g in tree_items(grads)}
    del grads
    loss_p, _, grads = loss_and_grads(
        params, dataclasses.replace(cfg, attn_impl="flash"), batch)
    gnorm_p = float(global_norm(grads))
    leaf_rel = {}
    for name, g in tree_items(grads):
        gk = grads_k.pop(name).to("cuda")
        leaf_rel[name] = float((gk.float() - g.float()).norm()
                               / g.float().norm())
        del gk
    del grads, grads_k
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    gnorm_rel = abs(gnorm_k - gnorm_p) / gnorm_p
    print(json.dumps({"train_kernel_vs_plain": {
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
        "loss_rel": loss_rel, "grad_norm_kernel": gnorm_k,
        "grad_norm_plain": gnorm_p, "grad_norm_rel": gnorm_rel,
        "leaf_rel": leaf_rel}}))
    if not (loss_rel <= TRAIN_LOSS_REL_TOL
            and gnorm_rel <= TRAIN_GNORM_REL_TOL
            and all(math.isfinite(v) and v <= TRAIN_LEAF_REL_TOL
                    for v in leaf_rel.values())):
        fail("training kernel path vs plain path out of its limits")
    torch.cuda.empty_cache()

    state = opt_init(cfg.optimizer, params)
    step = make_train_step(cfg, device="cuda")
    params, state, m0 = step(params, state, batch)          # warm-up
    first_loss = float(m0["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts to 0, 3 steps, counts read
    _zero_counters()
    losses, norms = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
    launches = _counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    after = float(make_eval_step(cfg, device="cuda")(params, batch))

    L = cfg.n_layers
    n = TRAIN_TIMED_STEPS
    want = {"flash_fwd": 2 * L * n, "flash_bwd_dq": L * n,
            "flash_bwd_dkv": L * n, "quantize": 11 * n, "dequantize": 11 * n,
            "checksum": 0, "shard_pack": 0, "shard_unpack": 0}
    if launches != want:
        fail(f"training launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in [first_loss, after, *losses,
                                          *norms]):
        fail(f"non-finite training loss or grad norm: {losses} {norms}")
    if not after < first_loss:
        fail(f"loss did not fall: first step {first_loss}, after "
             f"{n} more steps {after}")
    flops = train_model_flops(cfg, n_params)
    del params, state
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "params": n_params, "dtype": cfg.param_dtype,
            "optimizer": cfg.optimizer,
            "grad_compression": cfg.grad_compression, "remat": cfg.remat,
            "attn_impl": cfg.attn_impl, "batch": B, "seq": S,
            "timed_steps": n, "first_loss": first_loss,
            "step_losses": losses, "grad_norms": norms,
            "loss_after": after, "step_ms": step_ms,
            "tokens_per_s": B * S / (step_ms / 1e3), "peak_mem_gb": peak_gb,
            "model_flops_per_step": flops,
            "mfu": flops / (step_ms / 1e3) / BF16_FLOP_PER_S,
            "launches": launches,
            "kernel_vs_plain": {"loss_rel": loss_rel,
                                "grad_norm_rel": gnorm_rel,
                                "max_leaf_rel": max(leaf_rel.values())}}


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


def phase_storage_kernel_times(tree: dict) -> dict:
    """The storage kernels at the checkpoint's shapes, each beside its
    bound, its plain twin and the nearest PyTorch call: the checksum of
    the token embedding (102400 x 4096 bf16) and of every leaf of one
    save, and pack / unpack of the embedding into 16 targets of 64 KiB
    cells.  ``tree`` is a checkpoint on the card (path -> tensor)."""
    import torch
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import shard_pack as sp
    embed = tree["/params/embed/tok"]
    nbytes = embed.numel() * embed.element_size()
    leaves = list(tree.values())
    save_bytes = sum(v.numel() * v.element_size() for v in leaves)
    csum = {"ms": cuda_ms(lambda: ck.checksum(embed), iters=20),
            "plain_ms": cuda_ms(lambda: ck.checksum_reference(embed),
                                iters=3, warmup=1),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "per_save_ms": cuda_ms(lambda: [ck.checksum(v) for v in leaves],
                                   iters=5),
            "per_save_bytes": save_bytes, "per_save_leaves": len(leaves),
            "per_save_bound_ms": save_bytes / HBM_BYTES_PER_S * 1e3}
    width, cell_bytes = STRIPES[0]
    cells = ck.byte_view(embed).view(torch.int32).view(
        -1, cell_bytes // (sp.CELL_COLS * 4), sp.CELL_COLS)
    packed = sp.shard_pack(cells, width)
    cpt = cells.shape[0] // width
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    pack = {"ms": cuda_ms(lambda: sp.shard_pack(cells, width), iters=20),
            "plain_ms": cuda_ms(lambda: sp.shard_pack_reference(cells, width),
                                iters=20),
            "library_ms": cuda_ms(lambda: cells.view(
                cpt, width, *cells.shape[1:]).transpose(0, 1).contiguous(),
                iters=20),
            "bytes": 2 * nbytes, "bound_ms": bound, "bound_by": "bytes",
            "width": width, "cell_bytes": cell_bytes}
    unpack = {"ms": cuda_ms(lambda: sp.shard_unpack(packed), iters=20),
              "plain_ms": cuda_ms(lambda: sp.shard_unpack_reference(packed),
                                  iters=20),
              "library_ms": cuda_ms(lambda: packed.transpose(0, 1)
                                    .contiguous(), iters=20),
              "bytes": 2 * nbytes, "bound_ms": bound, "bound_by": "bytes",
              "width": width, "cell_bytes": cell_bytes}
    del packed, cells
    return {"checksum": csum, "shard_pack": pack, "shard_unpack": unpack}


def _profiled_ms(fn, names, iters: int = 5) -> dict:
    """Device ms per call of each named kernel inside ``fn`` (CUPTI, through
    torch.profiler), for kernels that one wrapper launches together."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name)
        if us <= 0:
            fail(f"the profiler saw no device time for {name}")
        out[name] = us / 1e3 / iters
    return out


def phase_train_kernel_times() -> dict:
    """The training slice's new kernels at its shapes: the backward pair at
    B=2, 32 heads, S=4096, D=128, causal, bf16, and quantize / dequantize
    over the 11 gradient leaves one step compresses (bf16 in, bf16 out),
    each beside its bound, its plain twin and the nearest PyTorch call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    B, S, Hq, n_kv, D = TRAIN_CASE[:5]
    gen = torch.Generator(device="cuda").manual_seed(15)
    (q, k, v), (q5, k4, v4) = make_qkv(TRAIN_CASE, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    do5 = do.reshape(B, S, n_kv, 1, D).permute(0, 2, 3, 1, 4)
    out5, lse = fa.flash_fwd(q5, k4, v4, causal=True)
    delta = (do5.float() * out5.float()).sum(-1)
    fwd_ms = cuda_ms(lambda: fa.flash_fwd(q5, k4, v4, causal=True), iters=5)
    with torch.no_grad():
        sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True), iters=5)
    bwd = lambda: fa.flash_bwd(q5, k4, v4, do5, lse, delta, causal=True)
    pair_ms = cuda_ms(bwd, iters=5)
    per = _profiled_ms(bwd, TC_KERNELS["flash_bwd"])
    plain_ms = cuda_ms(lambda: fa.flash_bwd_reference(
        q5, k4, v4, do5, lse, delta, causal=True), iters=2, warmup=1)
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    doh = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qh, kh, vh), doh, retain_graph=True), iters=5)
    # causal triangle: 2 B H D S(S+1)/2 FLOP per product; dq does 3
    # products, dk/dv 4, the pair only 5 (q.k and dO.v are shared)
    prod = 2.0 * B * Hq * D * S * (S + 1) / 2
    elt = q.element_size()
    io = lambda n_in, n_out: (n_in + n_out) * q.numel() * elt \
        + 2 * 4 * B * Hq * S                       # + lse, delta fp32

    def bound(flops, nbytes):
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")
    dq_bound = bound(3 * prod, io(4, 1))
    dkv_bound = bound(4 * prod, io(4, 2))
    pair_bound = bound(5 * prod, io(4, 3))
    # the forward: 2 products; q, k, v, out and the fp32 lse
    fwd_bound = bound(2 * prod, io(3, 1) - 4 * B * Hq * S)
    del q, k, v, do, q5, k4, v4, do5, out5, lse, delta, qh, kh, vh
    del sdpa_out, doh
    torch.cuda.empty_cache()

    cfg = get_arch(SLICE_ARCH)
    d, ff, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.padded_vocab()
    leaves = [(V, d), (d, V), (L, d, d), (L, d, d), (L, d, d), (L, d, d),
              (L, d, ff), (L, d, ff), (L, ff, d), (L, d), (L, d)]
    qt = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "elements": 0}
    dt = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    for shape in leaves:
        n = math.prod(shape)
        x = (torch.randn(shape, generator=gen, device="cuda") * 1e-3) \
            .to(torch.bfloat16).reshape(-1, qz.GROUP)
        qq, sc = qz.quantize(x)
        qt["ms"] += cuda_ms(lambda: qz.quantize(x), iters=5)
        qt["plain_ms"] += cuda_ms(lambda: qz.quantize_reference(x), iters=2,
                                  warmup=1)
        qt["bytes"] += n * 2 + n + 4 * n // qz.GROUP
        qt["elements"] += n
        dt["ms"] += cuda_ms(lambda: qz.dequantize(qq, sc, torch.bfloat16),
                            iters=5)
        dt["plain_ms"] += cuda_ms(lambda: qz.dequantize_reference(
            qq, sc, torch.bfloat16), iters=2, warmup=1)
        dt["library_ms"] += cuda_ms(lambda: qq * sc, iters=5)
        dt["bytes"] += n + 4 * n // qz.GROUP + n * 2
        del x, qq, sc
        torch.cuda.empty_cache()
    for t in (qt, dt):
        t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t["bound_by"] = "bytes"
    return {"flash_fwd_train_shape_ms": fwd_ms,
            "flash_fwd_train_shape_tflops_per_s": 2 * prod / (fwd_ms / 1e3)
            / 1e12,
            "flash_fwd_train_shape_bound_ms": fwd_bound[0],
            "flash_fwd_train_shape_bound_by": fwd_bound[1],
            "sdpa_fwd_train_shape_ms": sdpa_fwd_ms,
            "flash_bwd_pair_ms": pair_ms,
            "flash_bwd_pair_bound_ms": pair_bound[0],
            "flash_bwd_dq": {"ms": per["flash_bwd_dq_tc_kernel"],
                             "bound_ms": dq_bound[0],
                             "bound_by": dq_bound[1]},
            "flash_bwd_dkv": {"ms": per["flash_bwd_dkv_tc_kernel"],
                              "bound_ms": dkv_bound[0],
                              "bound_by": dkv_bound[1]},
            "flash_bwd_plain_pair_ms": plain_ms,
            "sdpa_backward_ms": library_ms,
            "quantize_per_step": qt, "dequantize_per_step": dt}


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
    fwd_train_err, bwd_err = phase_bwd_kernels()
    quant_err = phase_quant_kernels()
    storage_err = phase_storage_kernels()
    torch.cuda.empty_cache()
    slice_run = phase_slice()
    print(json.dumps({"slice": slice_run, "card": card}))
    offload_run = phase_serve_offload()
    print(json.dumps({"serve_offload": offload_run, "card": card}))
    train_run = phase_train()
    print(json.dumps({"train": train_run, "card": card}))
    ckpt_run = phase_ckpt_train()
    saved = ckpt_run.pop("copy")
    stripe_run = phase_stripe(saved)
    st = phase_storage_kernel_times(saved)
    print(json.dumps({"storage_kernel_times": st, "card": card}))
    del saved
    torch.cuda.empty_cache()
    times = phase_kernel_times()
    print(json.dumps({"kernel_times": times, "card": card}))
    tt = phase_train_kernel_times()
    print(json.dumps({"train_kernel_times": tt, "card": card}))
    print(json.dumps({"ckpt_train": {
        k: v for k, v in ckpt_run.items()
        if k in ("result", "run_s", "check_s", "launches", "timings",
                 "peak_mem_gb", "host_after")}, "card": card}))
    tl = train_run["launches"]
    bwd_plain = tt["flash_bwd_plain_pair_ms"]  # the twin computes the pair
    sdpa_bwd = tt["sdpa_backward_ms"]          # likewise
    qt, dt = tt["quantize_per_step"], tt["dequantize_per_step"]
    csrc = "src/repro_torch/kernels/csrc/"
    record = {"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": csrc + "flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": slice_run["flash_fwd_launches"] + tl["flash_fwd"]
        + sum(n["flash_fwd"] for n in offload_run["launches"].values()),
        "max_abs_err": max(slice_err, fwd_train_err), "ms": times["ms"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"],
        "tflops_per_s": times["tflops_per_s"],
        "ms_train_shape": tt["flash_fwd_train_shape_ms"],
        "tflops_per_s_train_shape": tt["flash_fwd_train_shape_tflops_per_s"],
        "bound_ms_train_shape": tt["flash_fwd_train_shape_bound_ms"],
        "library_ms_train_shape": tt["sdpa_fwd_train_shape_ms"]}, {
        "name": "flash_bwd_dq", "route": "cuda", "source": csrc + "flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:222",
        "launches": tl["flash_bwd_dq"], "max_abs_err": bwd_err,
        "ms": tt["flash_bwd_dq"]["ms"], "plain_ms": bwd_plain,
        "bound_ms": tt["flash_bwd_dq"]["bound_ms"],
        "bound_by": tt["flash_bwd_dq"]["bound_by"], "library_ms": sdpa_bwd}, {
        "name": "flash_bwd_dkv", "route": "cuda",
        "source": csrc + "flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:243",
        "launches": tl["flash_bwd_dkv"], "max_abs_err": bwd_err,
        "ms": tt["flash_bwd_dkv"]["ms"], "plain_ms": bwd_plain,
        "bound_ms": tt["flash_bwd_dkv"]["bound_ms"],
        "bound_by": tt["flash_bwd_dkv"]["bound_by"], "library_ms": sdpa_bwd}, {
        "name": "quantize", "route": "cuda", "source": csrc + "quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:37",
        "launches": tl["quantize"],
        "max_abs_err": max(quant_err["q"], quant_err["scale"]),
        "ms": qt["ms"], "plain_ms": qt["plain_ms"],
        "bound_ms": qt["bound_ms"], "bound_by": qt["bound_by"],
        "library_ms": None}, {
        "name": "dequantize", "route": "cuda", "source": csrc + "quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:58",
        "launches": tl["dequantize"],
        "max_abs_err": quant_err["dequantized"],
        "ms": dt["ms"], "plain_ms": dt["plain_ms"],
        "bound_ms": dt["bound_ms"], "bound_by": dt["bound_by"],
        "library_ms": dt["library_ms"]}, {
        "name": "checksum", "route": "cuda", "source": csrc + "checksum.cu",
        "replaces": "src/repro/kernels/checksum.py:44",
        "launches": ckpt_run["launches"]["checksum"]
        + sum(n["checksum"] for n in offload_run["launches"].values()),
        "max_abs_err": storage_err["checksum"],
        "ms": st["checksum"]["ms"], "plain_ms": st["checksum"]["plain_ms"],
        "bound_ms": st["checksum"]["bound_ms"],
        "bound_by": st["checksum"]["bound_by"], "library_ms": None}] + [{
        "name": name, "route": "cuda", "source": csrc + "shard_pack.cu",
        "replaces": replaces, "launches": stripe_run["launches"][name],
        "max_abs_err": storage_err[name], "ms": st[name]["ms"],
        "plain_ms": st[name]["plain_ms"], "bound_ms": st[name]["bound_ms"],
        "bound_by": st[name]["bound_by"],
        "library_ms": st[name]["library_ms"]}
        for name, replaces in (
            ("shard_pack", "src/repro/kernels/shard_pack.py:27"),
            ("shard_unpack", "src/repro/kernels/shard_pack.py:47"))]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

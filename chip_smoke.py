#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with no
result line, where there is none or where the port's sources are missing.
Phases, each fatal on failure:

1. print the card's name and power limit; build every kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and check that the bf16 flash-attention kernels multiply on the tensor
   cores (HMMA/HGMMA instructions in their SASS), the forward's and the
   backward's wgmma kernels (``WGMMA_KERNELS``) on wgmma (HGMMA) with no
   register spilled (ptxas -v), and the decode-attention kernels
   (``DECODE_ATTN_KERNELS``) with no register spilled, the tensor-core
   route's on HMMA;
2. hold each kernel against its plain torch version on the card: flash
   attention forward and backward in fp32 and bf16 at the reference tests'
   cases, a ragged S, D=256 and the slices' shapes (the MoE slices' GQA
   with G = 16 query heads a KV head and the hybrid's MQA with G = 16,
   D = 256 and window 2048 among them), the backward fed the
   forward kernel's own ``out`` and ``lse``, the cases of each pass
   reaching each of its routes (wgmma, mma, fp32; every serving and
   training shape on wgmma in bf16) and each run twice, bit for bit the
   same; quantize / dequantize
   bit for bit on a layer-sized gradient, an all-zero group and .5 ties;
   checksum and stripe pack / unpack bit for bit, the checksum also
   against ``core.integrity.checksum`` of the host bytes, up to a
   2.7 GB (> 2^31 bytes) leaf; decode attention (rope, the ring cache's
   slot write and the attention in one op) against its twin at every
   family's full-width decode shape, chat's and a device-bound G = 16 one
   (``DECODE_CASES``), bf16 and fp32, each shape on its route, then timed
   against its bound (its device time, the CUDA-core route's where the
   shape takes the tensor cores, and the library's version of the same
   step are read after the other kernel times, under the profiler);
3. drive the serving slice through the port's entry points at full width:
   deepseek-7b (30 layers, d 4096, bf16, random weights from a seeded
   generator on the card), ``attn_impl="flash_pallas"``, B=4 prompts of
   1024 tokens through ``make_prefill_step``, then 32 greedy
   ``make_decode_step`` steps; every launch counter is set to 0 just before
   and read just after, and the kernel must have run once per layer
   (``decode_attn`` once a layer a decode step, in every serving phase);
   every ``flash_fwd`` launch must have taken the wgmma route
   (``flash_attention.FWD_ROUTE_LAUNCHES``), as in every serving and
   training phase below; check the outputs (finite logits, kernel path vs
   the plain blockwise path, decode at position S vs a prefill of S+1
   tokens);
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
   just after (exact counts per step; every forward launch and backward
   pass on the wgmma route, ``flash_attention.BWD_ROUTE_LAUNCHES``), and
   check the loss falls; then the same steps timed with the backward, and
   with the forward, forced onto the mma.sync kernels;
   then the MoE family: qwen3-moe-235b-a22b at full width, its depth cut,
   serving (8 layers; the serving slice's prompts and decode steps with
   exact launch counts, each layer's drop fraction, decode at S against a
   prefill of S+1 at the no-drop capacity factor, one layer's ``moe_ffn``
   against the explicit per-token mixture) and training (2 layers; the
   training slice's checks, the aux loss finite and positive);
   then the recurrent families at full width: mamba2-370m (Mamba2 SSD, 48
   layers, no attention) serving (the serving slice's prompts and steps,
   no kernel launch, decode at S against a prefill of S+1, one layer's
   chunked SSD against its sequential recurrence in fp32) and training
   (the training slice's settings, exact quantize / dequantize counts, one
   layer's fp32 gradients on the card against the host's), and
   recurrentgemma-9b (Griffin: RG-LRU layers and local MQA attention, G =
   16, D = 256, window 2048) serving at full depth (exactly one
   ``flash_fwd`` a local-attention layer a prefill and none in decode,
   kernel vs blockwise hidden state, the decode identity, one rec layer's
   log-depth scan against its sequential recurrence in fp32) and training
   cut to 20 layers (the training slice's checks, the window biting at
   S = 4096);
   then the encoder-decoder, seamless-m4t-large-v2 (24 + 24 layers, 16
   MHA heads of 64), and the prefix-LM VLM, paligemma-3b (18 layers, 8 q
   heads over 1 KV head of 256, 256 stub patch embeddings as a
   bidirectional prefix), each at full width and depth, serving and
   training, the budgets split as ``text_len`` splits them (seamless: 512
   frames + 512 tokens serving, 2048 + 2048 training; paligemma: 256
   patches + 768 tokens, 256 + 3840): exact launch counts (seamless one
   ``flash_fwd`` an encoder layer and two a decoder layer, self and
   cross), kernel vs blockwise hidden state, decode at S against a prefill
   of S+1 (for seamless the cross-attention of 513 queries over 512
   keys), and the training slice's checks;
   then the dry-run held against the card (``phase_dryrun``): each of
   the six training slices above, and deepseek-7b's prefill of B=4 x 1024
   (run here on the card with exact launch counts, after the peak
   statistics are reset), counted by ``repro_torch.launch.dryrun`` on the
   meta device with the same config, depth cut, batch and sequence; each
   predicted peak (argument + temporary bytes) within DRYRUN_PEAK_REL_TOL
   of ``max_memory_allocated`` and the step's own bytes (temporary against
   the card's peak less what it held before the step) within
   DRYRUN_OWN_ABS_TOL_GB, the counted FLOPs printed against the model
   FLOPs, no kernel launched by a count; and the host time of a
   ``flash_fwd`` call through its op against the wrapper's;
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
   the nearest PyTorch call, the flash kernels also at the MoE, hybrid,
   encoder-decoder and VLM slices' shapes (SDPA with an explicit boolean
   mask under a window or prefix, and the backend it takes); the forward
   and the backward pair also on their mma.sync kernels (the mma route)
   on the same inputs, and the host time of building the backward's TMA
   tensor maps.

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

# The MoE slice: qwen3-moe-235b-a22b at full width (d 4096, 64 q heads over
# 4 KV heads of 128, 128 experts of ff 1536, top-8, vocab 151936, bf16),
# its depth cut from 94 layers: 8 for serving (8 x 4.976 GB of layers +
# 2.49 GB of embedding and head = 42.3 GB), 2 for training (the params,
# their gradients and Adafactor's bf16 moment, 3 x 12.4 GB, plus
# activations).  Its attention is GQA with G = 16 query heads a KV head.
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_SERVE_LAYERS = 8
MOE_TRAIN_LAYERS = 2
MOE_SERVE_CASE = (SLICE_BATCH, SLICE_PROMPT, 64, 4, 128, True, 0, 0)
MOE_TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ, 64, 4, 128, True, 0, 0)
# One layer's moe_ffn on the card against an explicit per-token mixture
# (every expert on every token, weighted by the top-k renormalised
# router probabilities, in fp32 from the same bf16 weights), at the no-drop
# capacity factor E/k: the bf16 path's largest |difference| over the
# mixture's largest |value| (bf16 inputs of the three products and of the
# gate product, each rounded at 2^-9), and the same layer in fp32
# (summation order only).
MOE_MIX_TOKENS = 256
MOE_MIX_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# Decode at S against a prefill of S+1.  In bf16 the two paths differ by
# bf16 noise (1.8e-2 in the dense slice), and where that noise moves a
# token's k-th and (k+1)-th router probabilities past each other, the
# token goes to another expert: a discrete jump of its whole expert
# output.  So over MOE_SERVE_LAYERS in bf16 the identity is held with the
# decode's routing replayed from the prefill's (the free reading is
# reported with the rows routed apart), and at full width in fp32, cut to
# MOE_CHECK_LAYERS layers (24.9 GB of params), both free and replayed.
# Likewise the training slice's kernel path against its plain path: the
# loss and grad norm are held free and replayed, each leaf replayed (the
# plain path takes the kernel path's choices), the free leaves reported.
MOE_CHECK_LAYERS = 2
# The recurrent families.  mamba2-370m (Mamba2 SSD: 48 layers, d 1024, 32
# SSD heads of 64 over a state of 128, chunk 256, vocab 50280, bf16) at
# full width and depth, serving and training: it has no attention layer,
# and its training step runs the int8 compression kernels.
# recurrentgemma-9b (Griffin: 38 layers, d 4096, RG-LRU width 4096, a
# local MQA layer every third, 16 q heads over 1 KV head of 256, window
# 2048, ff 12288, vocab 256000, bf16) serves at full depth (20.89 GB of
# params) and trains cut to 20 layers: 6 (rec, rec, local_attn)
# super-blocks and 2 leftover rec layers, 13.01 GB of params; at full
# depth the params, their gradients and Adafactor's bf16 moment alone take
# 62.7 GB.
SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_TRAIN_LAYERS = 20
HYBRID_SERVE_CASE = (SLICE_BATCH, SLICE_PROMPT, 16, 1, 256, True, 2048, 0)
HYBRID_TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ, 16, 1, 256, True, 2048, 0)
# In bf16 the two paths of an end-to-end serving comparison round in
# other places, and the recurrent state and the residual stream carry
# each layer's difference into the next: on an H100 80GB HBM3 at 700 W,
# mamba2's decode identity read 0.098 over 48 layers (fp32: 6.6e-5) and
# recurrentgemma's kernel-vs-blockwise hidden state 0.036 (fp32: 8.6e-6,
# each layer's kernel output on its own inputs 2.7e-3).  So those two are
# reported in bf16 and held in fp32 at full width and depth
# (``fp32_serving_checks``), at the limits above; recurrentgemma's bf16
# decode identity (0.043) is held as well.
# The encoder-decoder and the prefix-LM VLM at full width and depth,
# serving and training; the serving and training budgets (SLICE_PROMPT,
# TRAIN_SEQ positions) split as the reference's text_len splits them.
# seamless-m4t-large-v2: 24 encoder + 24 decoder layers, d 1024, 16 MHA
# heads of 64, ff 8192 gelu, vocab 256206 (256256 padded), sinusoidal
# positions; the encoder's bidirectional attention and the decoder's
# causal self-attention and bidirectional cross-attention each launch
# the flash kernels.  paligemma-3b: 18 layers, d 2048, 8 q heads over 1
# KV head of 256 (G = 8), ff 16384 geglu, vocab 257216 (257280 padded),
# 256 stub patch embeddings as a bidirectional prefix of the causal text
# (the kernels' prefix mask through the D > 128 column split).  Both
# train with their configs' AdamW (fp32 moments: 19.6 and 36.5 GB with
# the params and gradients), int8 compression and remat.
ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "paligemma-3b"
ENCDEC_SERVE_CASE = (SLICE_BATCH, SLICE_PROMPT // 2, 16, 16, 64, True, 0, 0)
ENCDEC_BIDIR_CASE = (SLICE_BATCH, SLICE_PROMPT // 2, 16, 16, 64, False, 0,
                     0)
ENCDEC_TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ // 2, 16, 16, 64, True, 0, 0)
ENCDEC_BIDIR_TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ // 2, 16, 16, 64, False,
                           0, 0)
# the decode identity's cross-attention: a prefill of S+1 = 513 decoder
# tokens over the 512 encoder frames (the case's 9th entry is Sk)
ENCDEC_CROSS_CASE = (SLICE_BATCH, SLICE_PROMPT // 2 + 1, 16, 16, 64, False,
                     0, 0, SLICE_PROMPT // 2)
VLM_SERVE_CASE = (SLICE_BATCH, SLICE_PROMPT, 8, 1, 256, True, 0, 256)
VLM_TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ, 8, 1, 256, True, 0, 256)
# One SSM layer at full width in fp32: the chunked ssd_forward against
# the sequential ssd_decode_step over SLICE_PROMPT steps, at the
# reference's chunked-vs-sequential tolerance (tests/test_models.py).
SSD_SEQ_TOL = 3e-3
# One rec layer at full width in fp32: the log-depth scan against the
# sequential rglru_decode_step over SLICE_PROMPT steps, relative norm of
# the difference.  Both compute in fp32; the scan reassociates the
# recurrence's products and sums (~1e-7 relative a step, over at most
# log2(S) = 10 levels), and the gate GEMMs run at other row counts.
RGLRU_SCAN_REL_TOL = 1e-4
# One SSM layer's parameter gradients at full width in fp32 on the card
# against the same computation on the host CPU from the same numbers
# (summation order only), relative norm of the difference per leaf.
SSM_GRAD_REL_TOL = 1e-4

# (B, S, Hq, n_kv, D, causal, window, prefix[, Sk]): the reference tests'
# cases, a ragged S, the MoE serving shape (G = 16), the hybrid's (MQA,
# G = 16, D = 256, window 2048), the encoder-decoder's (D = 64: causal,
# bidirectional, and bidirectional with Sq != Sk), the VLM's (G = 8,
# D = 256, prefix 256) and the slice's shape (last).  Sk defaults to S.
KERNEL_CASES = [
    (2, 64, 4, 2, 128, True, 0, 0),
    (2, 64, 4, 2, 80, True, 0, 0),
    (2, 96, 4, 1, 128, True, 32, 0),
    (2, 64, 4, 4, 128, True, 0, 16),
    (1, 64, 4, 4, 128, False, 0, 0),
    (2, 1000, 4, 2, 128, True, 0, 0),
    MOE_SERVE_CASE,
    HYBRID_SERVE_CASE,
    ENCDEC_SERVE_CASE,
    ENCDEC_BIDIR_CASE,
    ENCDEC_CROSS_CASE,
    VLM_SERVE_CASE,
    (SLICE_BATCH, SLICE_PROMPT, 32, 32, 128, True, 0, 0),
]
SERVE_CASES = (KERNEL_CASES[-1], MOE_SERVE_CASE, HYBRID_SERVE_CASE,
               ENCDEC_SERVE_CASE, ENCDEC_BIDIR_CASE, VLM_SERVE_CASE)
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
TRAIN_CASES = (TRAIN_CASE, MOE_TRAIN_CASE, HYBRID_TRAIN_CASE,
               ENCDEC_TRAIN_CASE, ENCDEC_BIDIR_TRAIN_CASE, VLM_TRAIN_CASE)
BWD_CASES = KERNEL_CASES[:6] + [(1, 333, 6, 3, 256, True, 100, 0),
                                MOE_SERVE_CASE, HYBRID_SERVE_CASE,
                                ENCDEC_CROSS_CASE, VLM_SERVE_CASE,
                                *TRAIN_CASES]
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
# The encoder-decoder's cross-attention q/k leaves (xattn wq, wk, norm3)
# read 0.158 in bf16 on that card, and 1e-4 in fp32: the flash backward
# takes delta = rowsum(dO * O) from the bf16-rounded O, as the reference's
# does, and delta's rounding error reaches dq and dk times the mean of k
# over the keys, which the true gradient cancels; the encoder's output,
# which has no final norm, is mostly that mean (rms 5.38 of 5.54 over
# positions).  With delta from an fp32 forward those leaves read 0.058
# against fp32, below the plain bf16 path's 0.068 (PERF.md).  So that
# family's leaves are held in fp32 at full width and depth and reported in
# bf16; its loss and grad norm are held in bf16 as every family's.
# The dry-run against the card (phase_dryrun): the predicted peak (the
# dry-run's argument + temporary bytes, counted on the meta device) against
# torch.cuda.max_memory_allocated() of the same step, |pred - card| / card.
# Fixed before the first card run.  The card's reading also holds the
# caching allocator's 512-byte rounding and unsplit block tails, cuBLAS's
# workspace and whatever an earlier phase still holds; the prediction
# holds none of them.
DRYRUN_PEAK_REL_TOL = 0.10
# The step's own bytes: the dry-run's temporary bytes against the card's
# peak less what the card held just before the step (arguments, cuBLAS's
# workspaces and the like: 0.105-0.109 GB beyond the arguments), in GB.
# Set from the first three card runs (NVIDIA H100 80GB HBM3, 700.00 W),
# which read 0.0094 GB at most (seamless-m4t-large-v2; 0.0021 mamba2-370m,
# under 1e-5 the rest), identical to the byte in all three; a dry-run that
# lost remat's saved layer inputs (some 2 GB of deepseek-7b's) misses it
# 40-fold.
DRYRUN_OWN_ABS_TOL_GB = 0.05
# The dry-run's prefill: deepseek-7b at full width and depth, the serving
# slice's batch and prompt, measured inside phase_dryrun.
DRYRUN_PREFILL = (SLICE_ARCH, SLICE_BATCH, SLICE_PROMPT)

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
                            "flash_bwd_dkv_tc_kernel"),
              "decode_attn": ("decode_attn_mma_kernel",)}
# The wgmma routes (bf16, D in {64, 128, 256}, aligned views: every serving
# and training shape), whose SASS must hold HGMMA (wgmma) instructions and
# whose ptxas report must show no spilled register.
WGMMA_KERNELS = {"flash_fwd": ("flash_fwd_wg_kernel",),
                 "flash_bwd": ("flash_bwd_dq_wg_kernel",
                               "flash_bwd_dkv_wg_kernel")}
ROUTES = ("wgmma", "mma", "fp32")
# its dk/dv pass's second kernel where the G groups are chunked
REDUCE_KERNEL = "flash_bwd_dkv_reduce_kernel"
# host microseconds of building one pass's tensor maps, over this many
MAP_BUILD_REPS = 2000
# The decode-attention kernels (csrc/decode_attn.cu): none may spill a
# register, and the tensor-core route's must hold HMMA instructions.
DECODE_ATTN_KERNELS = ("decode_attn_simt_kernel", "decode_attn_mma_kernel",
                       "decode_attn_combine_kernel")
DECODE_ROUTES = ("simt", "mma")
# Decode attention (phase_decode_attention): every family's full-width
# decode shape, (B, S_cache, Hq, n_kv, D, rotary_pct, rope_theta, pos):
# the serving slice's rows, prompts and slots to spare (recurrentgemma's
# ring of 2048 past its wrap; paligemma's 256 patches before its prompt;
# seamless's 512 decoder positions), chat's rounds of 16 at the first
# and last traced positions (cardbench's deepseek-7b.serve-chat), and
# qwen3-moe's G = 16 at 64 rows of 4096 slots, large enough that the
# device time, not the wrapper's host time, sets the pace (0.16 ms bound).
DECODE_CASES = {
    "deepseek": (SLICE_BATCH, SLICE_PROMPT + SLICE_PAD, 32, 32, 128, 1.0,
                 1e4, SLICE_PROMPT),
    "chat_first": (16, 1152, 32, 32, 128, 1.0, 1e4, 1024),
    "chat_last": (16, 1152, 32, 32, 128, 1.0, 1e4, 1055),
    "chatglm3": (SLICE_BATCH, 1056, 32, 2, 128, 0.5, 1e4, 1040),
    "stablelm": (SLICE_BATCH, 1056, 32, 32, 80, 0.25, 1e4, 1030),
    "h2o_danube": (SLICE_BATCH, 1056, 32, 8, 80, 1.0, 1e4, 1050),
    "qwen3_moe": (SLICE_BATCH, 1056, 64, 4, 128, 1.0, 1e6, 1055),
    "arctic": (SLICE_BATCH, 1056, 56, 8, 128, 1.0, 1e4, 1025),
    "paligemma": (SLICE_BATCH, 1312, 8, 1, 256, 1.0, 1e4, 1280),
    "recurrentgemma": (SLICE_BATCH, 2048, 16, 1, 256, 1.0, 1e4, 2100),
    "seamless": (SLICE_BATCH, 544, 16, 16, 64, 0.0, 1e4, 512),
    "g16_large": (64, 4096, 64, 4, 128, 1.0, 1e6, 4095),
}
# the flash forward's limits (TOL's "out")
DECODE_TOL = {"float32": 3e-4, "bfloat16": 1e-2}
# granite-4.0-h-small's decode attention (phase_decode_attention_scale):
# the chat cell's 16 rows over 1152 slots, 32 q / 8 kv heads of 128, no
# rope, softmax scale 1/128, at its first and last decode positions
GRANITE_DECODE = {"granite_first": (16, 1152, 32, 8, 128, 0.0, 1e4, 1024),
                  "granite_last": (16, 1152, 32, 8, 128, 0.0, 1e4, 1151)}
GRANITE_SCALE = 1 / 128


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


def _greedy(logits):
    """The greedy next token of each row, (B, 1) int32."""
    import torch
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def case_mask(case) -> dict:
    """A kernel case's mask arguments."""
    causal, window, prefix = case[5:8]
    return dict(causal=causal, window=window, prefix=prefix)


def case_sk(case) -> int:
    """A kernel case's key length: its 9th entry, else S."""
    return case[8] if len(case) > 8 else case[1]


def make_qkv(case, dtype, gen):
    """q, k, v in the model's (B, S, H, D) layout and the kernel's 5-D
    views of them (strided, no copies), as ``ops.flash_attention`` makes
    them."""
    import torch
    B, S, Hq, n_kv, D = case[:5]
    Sk = case_sk(case)
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, n_kv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, n_kv, D), generator=gen, device="cuda").to(dtype)
    q5 = q.reshape(B, S, n_kv, Hq // n_kv, D).permute(0, 2, 3, 1, 4)
    return (q, k, v), (q5, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))


def sass_mma_counts(lib, names, pattern=r"\bH(?:G)?MMA\b") -> dict | None:
    """The HMMA/HGMMA instruction count (or the count of ``pattern``'s
    matches) of each function in ``lib`` whose name holds one of ``names``
    (every template instance), from ``cuobjdump -sass``; None where the
    toolkit has no cuobjdump."""
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
        elif fn and re.search(pattern, line):
            counts[fn] += 1
    return counts


def ptxas_spills(log: str, names) -> dict:
    """Spilled bytes (stores + loads) that ``ptxas -v`` reports for each
    function in ``log`` whose name holds one of ``names``."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1) if any(k in m.group(1) for k in names) else None
            continue
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if fn and s:
            out[fn] = int(s.group(1)) + int(s.group(2))
            fn = None
    return out


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
    for lib, names in WGMMA_KERNELS.items():
        counts = sass_mma_counts(build.library_path(lib), names,
                                 r"\bHGMMA\b")
        print(json.dumps({"sass_hgmma_instructions": counts}))
        if counts is None:
            fail("no cuobjdump: the wgmma kernels' SASS cannot be read")
        if any(not any(k in fn for fn in counts) for k in names) \
                or not all(counts.values()):
            fail(f"a {lib} wgmma kernel has no HGMMA instruction: {counts}")
        if lib not in logs:
            fail(f"{lib} was not built by this run, so its ptxas report is "
                 f"missing (remove build/)")
        spills = ptxas_spills(logs[lib], names)
        print(json.dumps({"ptxas_spill_bytes": spills}))
        if any(not any(k in fn for fn in spills) for k in names) \
                or any(spills.values()):
            fail(f"a {lib} wgmma kernel spills registers: {spills}")
    if "decode_attn" not in logs:
        fail("decode_attn was not built by this run, so its ptxas report "
             "is missing (remove build/)")
    spills = ptxas_spills(logs["decode_attn"], DECODE_ATTN_KERNELS)
    print(json.dumps({"decode_attn_ptxas_spill_bytes": spills}))
    if any(not any(k in fn for fn in spills) for k in DECODE_ATTN_KERNELS) \
            or any(spills.values()):
        fail(f"a decode_attn kernel spills registers: {spills}")


def moved_route(counts: dict, before: dict, by: int) -> str:
    """The one route whose launch count moved, by ``by``, since
    ``before``; fails on any other movement."""
    moved = [r for r in before if counts[r] != before[r]]
    if len(moved) != 1 or counts[moved[0]] != before[moved[0]] + by:
        fail(f"launches by route moved from {before} to {counts}")
    return moved[0]


def want_fwd_route(case, dtype) -> str | None:
    """The route a serving or training shape must take (wgmma in bf16,
    fp32 in fp32); None for the other cases."""
    import torch
    if case not in SERVE_CASES + TRAIN_CASES + (ENCDEC_CROSS_CASE,):
        return None
    return "wgmma" if dtype == torch.bfloat16 else "fp32"


def phase_kernels() -> float:
    """Kernel vs plain version on the card, each launch's route printed
    (every serving and training shape on wgmma in bf16, the cases on all
    three routes); returns the largest bf16 |out error| at the serving
    slices' shapes (deepseek-7b, qwen3-moe, recurrentgemma-9b,
    seamless-m4t-large-v2 and paligemma-3b)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(11)
    slice_err = 0.0
    routes_seen = {}
    for case in KERNEL_CASES:
        mask = case_mask(case)
        for dtype in (torch.float32, torch.bfloat16):
            _, (q5, k4, v4) = make_qkv(case, dtype, gen)
            before = dict(fa.FWD_ROUTE_LAUNCHES)
            out, lse = fa.flash_fwd(q5, k4, v4, **mask)
            torch.cuda.synchronize()
            route = moved_route(fa.FWD_ROUTE_LAUNCHES, before, 1)
            routes_seen[route] = routes_seen.get(route, 0) + 1
            # the same inputs again: bitwise the same (one writer a row)
            again = fa.flash_fwd(q5, k4, v4, **mask)
            bitwise = torch.equal(out, again[0]) and \
                torch.equal(lse, again[1])
            del again
            ref_out, ref_lse = fa.flash_fwd_reference(
                q5.float(), k4.float(), v4.float(), **mask)
            r = check_fwd(out, lse, ref_out, ref_lse, dtype)
            print(json.dumps({"kernel": "flash_fwd", "case": case,
                              "dtype": str(dtype), "route": route,
                              "bitwise_repeat": bitwise, **r}))
            if want_fwd_route(case, dtype) not in (None, route):
                fail(f"flash_fwd at a serving shape took the {route} "
                     f"route: {case} {dtype}")
            if not r["ok"] or not bitwise:
                fail(f"flash_fwd disagrees with its plain version or gave "
                     f"different bits on the same inputs: {case} {dtype}")
            if case in SERVE_CASES and dtype == torch.bfloat16:
                slice_err = max(slice_err, r["max_abs_err_out"])
    print(json.dumps({"flash_fwd_cases_by_route": routes_seen}))
    if set(routes_seen) != set(ROUTES):
        fail(f"the forward cases did not reach every route: {routes_seen}")
    # a negative scale at the serving shape: the bf16 kernels run it on a
    # negated q tile with |scale|
    case = KERNEL_CASES[-1]
    scale = -1.0 / math.sqrt(case[4])
    _, (q5, k4, v4) = make_qkv(case, torch.bfloat16, gen)
    before = dict(fa.FWD_ROUTE_LAUNCHES)
    out, lse = fa.flash_fwd(q5, k4, v4, causal=True, scale=scale)
    torch.cuda.synchronize()
    route = moved_route(fa.FWD_ROUTE_LAUNCHES, before, 1)
    ref_out, ref_lse = fa.flash_fwd_reference(
        q5.float(), k4.float(), v4.float(), causal=True, scale=scale)
    r = check_fwd(out, lse, ref_out, ref_lse, torch.bfloat16)
    print(json.dumps({"kernel": "flash_fwd", "case": case, "scale": scale,
                      "dtype": str(torch.bfloat16), "route": route, **r}))
    if route != "wgmma" or not r["ok"]:
        fail(f"flash_fwd with a negative scale took the {route} route or "
             f"disagrees with its plain version: {case}")
    return slice_err


def phase_bwd_kernels() -> tuple[float, float]:
    """The forward kernel, then the backward kernels fed its own ``out``
    and ``lse`` as the training step feeds them, each against its plain
    version on the card; returns the largest bf16 |error| of ``out`` and
    over dq, dk and dv at the training slices' shapes (deepseek-7b,
    qwen3-moe, recurrentgemma-9b, seamless-m4t-large-v2 and paligemma-3b).
    Runs before any model is loaded:
    at the qwen3-moe shape the plain versions hold several 8.6 GB
    (B, n_kv, G, S, S) fp32 tensors."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(13)
    fwd_err = bwd_err = 0.0
    routes_seen, fwd_routes_seen = {}, {}
    for case in BWD_CASES:
        mask = case_mask(case)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            B, S, Hq, n_kv, D = case[:5]
            (q, _, _), (q5, k4, v4) = make_qkv(case, dtype, gen)
            do5 = torch.randn(q.shape, generator=gen, device="cuda") \
                .to(dtype).reshape(B, S, n_kv, Hq // n_kv, D) \
                .permute(0, 2, 3, 1, 4)
            before = dict(fa.FWD_ROUTE_LAUNCHES)
            out, lse = fa.flash_fwd(q5, k4, v4, **mask)
            torch.cuda.synchronize()
            fwd_route = moved_route(fa.FWD_ROUTE_LAUNCHES, before, 1)
            fwd_routes_seen[fwd_route] = \
                fwd_routes_seen.get(fwd_route, 0) + 1
            ref_out, ref_lse = fa.flash_fwd_reference(
                q5.float(), k4.float(), v4.float(), **mask)
            fwd = check_fwd(out, lse, ref_out, ref_lse, dtype)
            del ref_out, ref_lse
            delta = (do5.float() * out.float()).sum(-1)
            del out
            before = dict(fa.BWD_ROUTE_LAUNCHES)
            got = fa.flash_bwd(q5, k4, v4, do5, lse, delta, **mask)
            torch.cuda.synchronize()
            route = moved_route(fa.BWD_ROUTE_LAUNCHES, before, 2)
            routes_seen[route] = routes_seen.get(route, 0) + 1
            # the same inputs again: bitwise the same (one writer an output)
            again = fa.flash_bwd(q5, k4, v4, do5, lse, delta, **mask)
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
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
                              "route": route, "fwd_route": fwd_route,
                              "bitwise_repeat": bitwise,
                              "fwd": fwd, "max_abs_err_dq_dk_dv": errs,
                              "block_rel_err_dq_dk_dv": block_errs,
                              "ok": ok}))
            if not bitwise:
                fail(f"flash_bwd gave different bits on the same inputs: "
                     f"{case} {dtype}")
            if want_fwd_route(case, dtype) not in (None, fwd_route):
                fail(f"flash_fwd at a serving or training shape took the "
                     f"{fwd_route} route: {case} {dtype}")
            if case in TRAIN_CASES and route != {
                    torch.float32: "fp32", torch.bfloat16: "wgmma"}[dtype]:
                fail(f"flash_bwd at a training shape took the {route} "
                     f"route: {case} {dtype}")
            if not fwd["ok"]:
                fail(f"flash_fwd disagrees with its plain version: {case} "
                     f"{dtype}")
            if not ok:
                fail(f"flash_bwd disagrees with its plain version: {case} "
                     f"{dtype}")
            if case in TRAIN_CASES and dtype == torch.bfloat16:
                fwd_err = max(fwd_err, fwd["max_abs_err_out"])
                bwd_err = max(bwd_err, *errs)
            del got, want, lse, delta
    torch.cuda.empty_cache()
    print(json.dumps({"flash_bwd_cases_by_route": routes_seen,
                      "flash_fwd_cases_by_route": fwd_routes_seen}))
    if set(fwd_routes_seen) != set(ROUTES):
        fail(f"the forward cases did not reach every route: "
             f"{fwd_routes_seen}")
    if set(routes_seen) != set(ROUTES):
        fail(f"the backward cases did not reach every route: {routes_seen}")
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


def _ulps(a, b) -> int:
    """The most units in the last place between two same-dtype tensors."""
    import torch
    it = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return int((a.view(it).long() - b.view(it).long()).abs().max())


def decode_library(q, k, v, ck, cv, pos: int, inv, rot: int):
    """The same decode step from PyTorch's own calls, as a yardstick: rope
    from the inverse frequencies kept on the card (fp32 products rounded
    once, as the twin), the new k and v written into the slot in place,
    and ``scaled_dot_product_attention`` (``enable_gqa``) over the bf16
    caches' valid slots as they lie, a (B, Hkv, n_valid, D) view."""
    import torch
    import torch.nn.functional as F
    B, _, Hq, D = q.shape
    S, Hkv = ck.shape[1], ck.shape[2]

    def rope(x):
        if rot == 0:
            return x
        ang = inv * float(pos)
        c, s = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :rot // 2].float(), x[..., rot // 2:rot].float()
        return torch.cat([(x1 * c - x2 * s).to(x.dtype),
                          (x2 * c + x1 * s).to(x.dtype), x[..., rot:]], -1)

    slot, n = pos % S, min(pos + 1, S)
    ck[:, slot] = rope(k)[:, 0]
    cv[:, slot] = v[:, 0]
    out = F.scaled_dot_product_attention(
        rope(q).transpose(1, 2), ck[:, :n].transpose(1, 2),
        cv[:, :n].transpose(1, 2), enable_gqa=Hq != Hkv)
    return out.transpose(1, 2)


def _device_ms_and_launches(fn, iters: int = 5) -> tuple[float, float]:
    """Device ms and device operations a call of ``fn`` (torch.profiler:
    the sum of the device events' durations, and their count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        fail("the profiler saw no device operation")
    us = sum(e.time_range.end - e.time_range.start for e in ev)
    return us / 1e3 / iters, len(ev) / iters


def forced_decode_route(da, route: str):
    """A context in which ``decode_attn`` takes ``route`` whatever its
    inputs (``_route`` replaced), to time one design against another on
    the same inputs; for measurement only."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        real = da._route
        da._route = lambda *a: route
        try:
            yield
        finally:
            da._route = real
    return ctx()


def _decode_inputs(case, dtype):
    """q, k, v (before rope) and the two caches of a DECODE_CASES shape,
    drawn on the card from a seed of the shape."""
    import torch
    B, S, Hq, n_kv, D = case[:5]
    gen = torch.Generator(device="cuda").manual_seed(S * D + Hq)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return (mk(B, 1, Hq, D), mk(B, 1, n_kv, D), mk(B, 1, n_kv, D),
            mk(B, S, n_kv, D), mk(B, S, n_kv, D))


def phase_decode_attention() -> dict:
    """The decode-attention kernel (``kernels.decode_attention``) against
    its plain twin, run on the card in the same dtype, at every
    DECODE_CASES shape in bf16 and fp32: the output within DECODE_TOL, the
    v slot bit-equal and the k slot within one ulp, every other slot
    untouched, one launch on the route the shape takes (bf16 with G > 4
    on the tensor cores).  Then, in bf16, its time (CUDA events; each call
    writes its slot again, the same values) against its bound
    (``decode_attn_bytes`` at HBM_BYTES_PER_S: q, each valid K/V row once,
    the slot and the output) and the twin's.  Device times come later,
    from ``phase_decode_attention_times``."""
    import torch
    from repro_torch.kernels import decode_attention as da
    out, worst = {}, 0.0
    for name, case in DECODE_CASES.items():
        B, S, Hq, n_kv, D, pct, theta, pos = case
        r = {"case": list(case)}
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, k, v, ck, cv = _decode_inputs(case, dtype)
            ck0, cv0 = ck.clone(), cv.clone()
            route = da._route(dtype, Hq // n_kv)
            _zero_counters()
            got = da.decode_attn(q, k, v, ck, cv, pos, pct, theta, False)
            torch.cuda.synchronize()
            routes = dict(da.ROUTE_LAUNCHES)
            want = da.decode_attention_reference(q, k, v, ck0, cv0, pos,
                                                 pct, theta, False)
            slot = pos % S
            keep = torch.arange(S, device="cuda") != slot
            err = float((got.float() - want.float()).abs().max())
            r[dn] = {"route": route, "max_abs_err": err,
                     "k_slot_ulps": _ulps(ck[:, slot], ck0[:, slot])}
            print(json.dumps({"decode_attn_check": {name: {dn: r[dn]}}}))
            if not torch.allclose(got.float(), want.float(),
                                  rtol=DECODE_TOL[dn], atol=DECODE_TOL[dn]):
                fail(f"decode_attn {name} {dn}: max |error| {err}")
            if not torch.equal(cv[:, slot], cv0[:, slot]) \
                    or r[dn]["k_slot_ulps"] > 1:
                fail(f"decode_attn {name} {dn}: the slot differs from the "
                     f"twin's (k by {r[dn]['k_slot_ulps']} ulp)")
            if not (torch.equal(ck[:, keep], ck0[:, keep])
                    and torch.equal(cv[:, keep], cv0[:, keep])):
                fail(f"decode_attn {name} {dn}: a slot other than {slot} "
                     f"changed")
            if routes != {k2: int(k2 == route) for k2 in DECODE_ROUTES}:
                fail(f"decode_attn {name} {dn}: launches by route {routes}")
            worst = max(worst, err)
            if dtype == torch.bfloat16:
                n_gc = da._group_chunks(route, Hq // n_kv)
                r["splits"] = da.decode_splits(B, n_kv * n_gc,
                                               min(pos + 1, S))
                r["ms"] = cuda_ms(lambda: da.decode_attn(
                    q, k, v, ck, cv, pos, pct, theta, False), iters=50)
                r["plain_ms"] = cuda_ms(
                    lambda: da.decode_attention_reference(
                        q, k, v, ck0, cv0, pos, pct, theta, False), iters=5)
                r["bound_ms"] = da.decode_attn_bytes(
                    q, k, v, ck, cv, pos) / HBM_BYTES_PER_S * 1e3
            del q, k, v, ck, cv, ck0, cv0, got, want
        out[name] = r
        print(json.dumps({"decode_attn": {name: r}}))
    _zero_counters()
    torch.cuda.empty_cache()
    out["max_abs_err"] = worst
    return out


def phase_decode_attention_scale(device_times: bool = False) -> dict:
    """The decode-attention kernel at granite-4.0-h-small's shapes
    (GRANITE_DECODE) with its softmax scale (GRANITE_SCALE) against the
    twin at that scale, bf16 and fp32 (DECODE_TOL), the new k/v in their
    slot; the default scale's twin must miss it.  In bf16 its time (CUDA
    events) against the byte bound, and with ``device_times`` the
    profiler's device ms and share of the bound (run that late, as
    ``phase_decode_attention_times`` is)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    out = {}
    for name, case in GRANITE_DECODE.items():
        B, S, Hq, n_kv, D, pct, theta, pos = case
        r = {"case": list(case), "scale": GRANITE_SCALE}
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, k, v, ck, cv = _decode_inputs(case, dtype)
            ck0, cv0 = ck.clone(), cv.clone()
            call = lambda: da.decode_attn(q, k, v, ck, cv, pos, pct, theta,
                                          False, GRANITE_SCALE)
            got = call()
            torch.cuda.synchronize()
            want = da.decode_attention_reference(q, k, v, ck0.clone(),
                                                 cv0.clone(), pos, pct, theta,
                                                 False, GRANITE_SCALE)
            default = da.decode_attention_reference(q, k, v, ck0, cv0, pos,
                                                    pct, theta, False)
            err = float((got.float() - want.float()).abs().max())
            r[dn] = {"route": da._route(dtype, Hq // n_kv),
                     "max_abs_err": err,
                     "default_scale_gap": float(
                         (default.float() - want.float()).abs().max())}
            if not torch.allclose(got.float(), want.float(),
                                  rtol=DECODE_TOL[dn], atol=DECODE_TOL[dn]):
                fail(f"decode_attn {name} {dn} at scale {GRANITE_SCALE}: "
                     f"max |error| {err}")
            if r[dn]["default_scale_gap"] < 10 * DECODE_TOL[dn]:
                fail(f"decode_attn {name} {dn}: the set scale is not taken")
            if not (torch.equal(ck[:, pos], k[:, 0])
                    and torch.equal(cv[:, pos], v[:, 0])):
                fail(f"decode_attn {name} {dn}: the slot differs from k/v")
            if dtype == torch.bfloat16:
                bound = da.decode_attn_bytes(q, k, v, ck, cv, pos) \
                    / HBM_BYTES_PER_S * 1e3
                r["bound_ms"] = bound
                r["ms"] = cuda_ms(call, iters=50)
                if device_times:
                    r["device_ms"], r["launches"] = \
                        _device_ms_and_launches(call)
                    r["share_of_bound"] = bound / r["device_ms"]
            del q, k, v, ck, cv, ck0, cv0, got, want, default
        out[name] = r
        print(json.dumps({"decode_attn_scale": {name: r}}))
    _zero_counters()
    torch.cuda.empty_cache()
    return out


def phase_decode_attention_times() -> dict:
    """At every DECODE_CASES shape in bf16, the decode-attention kernel's
    device time and device operations a call (the profiler's:
    ``device_ms``, ``launches``) and its share of the byte bound; the
    CUDA-core route's device time where the shape takes the tensor cores
    (``simt_device_ms``); and the library's version of the same step
    (``decode_library``: its error against the twin, its time, device
    time and device operations a call, and the backend its attention
    takes).  Run after the other kernel-time phases, where the profiler
    is first started."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    out = {}
    for name, case in DECODE_CASES.items():
        B, S, Hq, n_kv, D, pct, theta, pos = case
        q, k, v, ck, cv = _decode_inputs(case, torch.bfloat16)
        lk, lv = ck.clone(), cv.clone()
        want = da.decode_attention_reference(q, k, v, ck.clone(), cv.clone(),
                                             pos, pct, theta, False)
        route = da._route(torch.bfloat16, Hq // n_kv)
        call = lambda: da.decode_attn(q, k, v, ck, cv, pos, pct, theta,
                                      False)
        r = {"route": route}
        r["device_ms"], r["launches"] = _device_ms_and_launches(call)
        r["share_of_bound"] = da.decode_attn_bytes(
            q, k, v, ck, cv, pos) / HBM_BYTES_PER_S * 1e3 / r["device_ms"]
        if route != "simt":
            with forced_decode_route(da, "simt"):
                r["simt_device_ms"] = _device_ms_and_launches(call)[0]
        inv, rot = da._inv_freq(q.device, D, pct, theta)
        lib = lambda: decode_library(q, k, v, lk, lv, pos, inv, rot)
        r["library_max_abs_err"] = float(
            (lib().float() - want.float()).abs().max())
        r["library_ms"] = cuda_ms(lib, iters=50)
        r["library_device_ms"], r["library_launches"] = \
            _device_ms_and_launches(lib)
        n = min(pos + 1, S)
        r["library_attention"] = sdpa_backend(
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), lk[:, :n].transpose(1, 2),
                lv[:, :n].transpose(1, 2),
                enable_gqa=Hq != n_kv))["backend"]
        del q, k, v, ck, cv, lk, lv, want
        out[name] = r
        print(json.dumps({"decode_attn_times": {name: r}}))
    _zero_counters()
    torch.cuda.empty_cache()
    return out


def attn_layers(cfg) -> int:
    """The attention layers of an architecture: each launches ``flash_fwd``
    once a prefill under ``flash_pallas`` (an encoder-decoder's decoder
    layer twice: self- and cross-attention)."""
    from repro_torch.models.transformer import block_kinds
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    return sum(k != "ssm" and k != "rec" for k in block_kinds(cfg))


def decode_attn_layers(cfg) -> int:
    """The layers that launch ``decode_attn`` once a decode step: every
    attention layer, the encoder-decoder's decoder self-attention only
    (its cross-attention and encoder take none)."""
    if cfg.family == "encdec":
        return cfg.dec_layers
    return attn_layers(cfg)


def model_inputs(cfg, gen, B: int, S: int) -> dict:
    """A batch of B rows for a budget of S positions through the port's
    ``make_inputs``, split as the reference's ``text_len`` splits it: the
    tokens, then the VLM's stub patch embeddings or the encoder-decoder's
    stub frame embeddings, drawn from ``gen`` on the card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import make_inputs
    return make_inputs(gen, cfg, ShapeConfig("slice", S, B, "prefill"),
                       device="cuda")


def prompt_positions(cfg, batch) -> int:
    """The positions a prefill of ``batch`` caches: the decoder's tokens,
    after the VLM's patches."""
    return batch["tokens"].shape[1] + cfg.n_prefix_tokens


def serve_main_path(cfg) -> tuple[dict, dict]:
    """A serving slice at full width through the port's entry points:
    params from a seeded generator on the card, B=SLICE_BATCH prompts of
    SLICE_PROMPT positions (``model_inputs``) through
    ``make_prefill_step``, then
    SLICE_DECODE_STEPS greedy ``make_decode_step`` steps, after a warm-up.
    Every launch counter is set to 0 just before the prefill and before
    the decode steps and read just after each: ``flash_fwd`` must run once
    an attention layer in the prefill and nothing else anywhere.  The logits must be
    finite and the tokens in the vocabulary.  Returns the state the
    phase's checks go on from (params, the batch and its tokens, steps,
    the first greedy token, the first decode step's logits, the last token
    and the cache) and the readings."""
    import torch
    from repro_torch.models import init_model, param_count
    from repro_torch.serve import make_decode_step, make_prefill_step

    B = SLICE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_model(gen, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = model_inputs(cfg, gen, B, SLICE_PROMPT)
    prompts = batch["tokens"]
    S = prompt_positions(cfg, batch)       # the decoder's first position
    prefill = make_prefill_step(cfg, pad_to=S + SLICE_PAD, device="cuda")
    decode = make_decode_step(cfg, device="cuda")

    # warm-up: library load, cuBLAS handles, allocator (not counted)
    logits, cache = prefill(params, batch)
    decode(params, cache, _greedy(logits), S)
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts to 0, one prefill, greedy decode, counts read
    _zero_counters()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches, routes = {"prefill": _counters()}, {"prefill": _routes()}
    _zero_counters()
    tok0 = tok = _greedy(logits)
    generated = []
    t0 = time.perf_counter()
    for t in range(SLICE_DECODE_STEPS):
        tok, step_logits, cache = decode(params, cache, tok, S + t)
        if t == 0:
            decode0_logits = step_logits
        generated.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / SLICE_DECODE_STEPS
    launches["decode"], routes["decode"] = _counters(), _routes()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = {part: {n: 0 for n in c} for part, c in launches.items()}
    want["prefill"]["flash_fwd"] = attn_layers(cfg)
    want["decode"]["decode_attn"] = decode_attn_layers(cfg) \
        * SLICE_DECODE_STEPS
    if launches != want:
        fail(f"{cfg.name} serving launches {launches}, want {want}")
    for part in launches:
        _hold_wgmma_route(f"{cfg.name} serving {part}", launches[part],
                          routes[part])
    gen_tokens = torch.cat(generated, dim=1)
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(step_logits).all())
            and bool(torch.isfinite(decode0_logits).all())):
        fail(f"{cfg.name} serving: non-finite logits")
    if gen_tokens.shape != (B, SLICE_DECODE_STEPS) or \
            int(gen_tokens.min()) < 0 or \
            int(gen_tokens.max()) >= cfg.padded_vocab():
        fail(f"{cfg.name} serving: bad generated tokens "
             f"{tuple(gen_tokens.shape)}")
    state = {"params": params, "batch": batch, "prompts": prompts,
             "prefill": prefill, "decode": decode, "tok0": tok0,
             "decode0_logits": decode0_logits, "tok": tok, "cache": cache}
    return state, {
        "arch": cfg.name, "layers": cfg.n_layers,
        "params": param_count(params), "dtype": cfg.param_dtype,
        "batch": B, "prompt": SLICE_PROMPT,
        "inputs": {k: list(v.shape) for k, v in batch.items()},
        "pad_to": S + SLICE_PAD,
        "decode_steps": SLICE_DECODE_STEPS, "init_s": init_s,
        "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": B * SLICE_PROMPT / (prefill_ms / 1e3),
        "decode_ms_per_step": decode_ms,
        "decode_tokens_per_s": B / (decode_ms / 1e3),
        "peak_mem_gb": peak_gb, "launches": launches, "routes": routes}


def hold(what: str, reading: float, limit: float) -> None:
    """Fail unless ``reading`` is finite and within ``limit``."""
    if not math.isfinite(reading) or reading > limit:
        fail(f"{what}: {reading} (limit {limit})")


def hidden_vs_blockwise(params, cfg, batch) -> float:
    """The kernel path's last-token hidden state against the plain
    blockwise path's: the relative norm error."""
    import torch
    from repro_torch.models import forward_prefill
    pad_to = prompt_positions(cfg, batch) + SLICE_PAD
    with torch.no_grad():
        h_kernel, c = forward_prefill(params, cfg, batch, pad_to=pad_to)
        h_kernel = h_kernel[:, -1].float()
        del c
        h_plain, c = forward_prefill(
            params, dataclasses.replace(cfg, attn_impl="flash"), batch,
            pad_to=pad_to)
        h_plain = h_plain[:, -1].float()
        del c
    return rel_err(h_kernel, h_plain)


def decode_vs_prefill(st: dict) -> dict:
    """The prefill-then-decode identity on ``serve_main_path``'s state:
    the first decode step's logits (at position S) against the last row
    of a prefill of S+1 tokens, the relative norm error and the greedy
    tokens' agreement."""
    import torch
    full_logits, c = st["prefill"](st["params"], dict(
        st["batch"], tokens=torch.cat([st["batch"]["tokens"], st["tok0"]],
                                      dim=1)))
    del c
    decode0_logits = st["decode0_logits"]
    return {"rel_err": rel_err(decode0_logits[:, -1], full_logits[:, -1]),
            "argmax_agree": float((_greedy(decode0_logits)
                                   == _greedy(full_logits)).float().mean())}


def phase_slice() -> dict:
    """The serving slice at full width through the port's entry points
    (``serve_main_path``), then the kernel path's last-token hidden state
    against the plain blockwise path's, and decode at S against a prefill
    of S+1."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(SLICE_ARCH), attn_impl="flash_pallas")
    st, r = serve_main_path(cfg)
    del st["cache"]
    hidden_rel = hidden_vs_blockwise(st["params"], cfg, st["batch"])
    hold("kernel-path hidden state vs blockwise", hidden_rel, HIDDEN_REL_TOL)
    ident = decode_vs_prefill(st)
    hold("decode at S vs prefill of S+1", ident["rel_err"], DECODE_REL_TOL)
    r.update({"flash_fwd_launches": sum(
                  c["flash_fwd"] for c in r["launches"].values()),
              "hidden_rel_err_vs_blockwise": hidden_rel,
              "hidden_rel_tol": HIDDEN_REL_TOL,
              "decode_vs_prefill_rel_err": ident["rel_err"],
              "decode_rel_tol": DECODE_REL_TOL,
              "decode_vs_prefill_argmax_agree": ident["argmax_agree"]})
    return r


def ssd_chunked_vs_sequential(lp: dict, cfg, gen) -> dict:
    """One SSM layer at full width in fp32 (the bf16 layer's params
    widened): ``ssd_forward``'s chunks against SLICE_PROMPT sequential
    ``ssd_decode_step`` steps from a zero state, outputs and final state,
    at SSD_SEQ_TOL (as tests/test_models.py holds them)."""
    import torch
    from repro_torch.models import ssm
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    p32 = {n: w.float() for n, w in lp.items()}
    B, S = SLICE_BATCH, SLICE_PROMPT
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    with torch.no_grad():
        y, final, tail = ssm.ssd_forward(p32, x, cfg32)
        state = torch.zeros_like(final)
        conv = torch.zeros_like(tail)
        ys = []
        for t in range(S):
            y_t, state, conv = ssm.ssd_decode_step(p32, x[:, t:t + 1],
                                                   cfg32, state, conv)
            ys.append(y_t)
        y_seq = torch.cat(ys, dim=1)
    r = {"steps": S, "chunk": ssm.chunk_len(S, cfg.ssm_chunk),
         "max_abs_err_y": float((y - y_seq).abs().max()),
         "max_abs_err_state": float((final - state).abs().max()),
         "rel_err_y": rel_err(y, y_seq), "y_abs_max": float(y.abs().max())}
    r["ok"] = (torch.allclose(y, y_seq, rtol=SSD_SEQ_TOL, atol=SSD_SEQ_TOL)
               and torch.allclose(final, state, rtol=SSD_SEQ_TOL,
                                  atol=SSD_SEQ_TOL))
    return r


def rglru_scan_vs_sequential(lp: dict, cfg, gen) -> dict:
    """One rec layer at full width in fp32 (the bf16 layer's params
    widened): ``rglru_block``'s log-depth scan against SLICE_PROMPT
    sequential ``rglru_decode_step`` steps from a zero state, at
    RGLRU_SCAN_REL_TOL."""
    import torch
    from repro_torch.models import rglru
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    p32 = {n: w.float() for n, w in lp.items()}
    B, S = SLICE_BATCH, SLICE_PROMPT
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    with torch.no_grad():
        y, h, tail = rglru.rglru_block(p32, x, cfg32)
        state = torch.zeros_like(h)
        conv = torch.zeros_like(tail)
        ys = []
        for t in range(S):
            y_t, state, conv = rglru.rglru_decode_step(p32, x[:, t:t + 1],
                                                       cfg32, state, conv)
            ys.append(y_t)
        y_seq = torch.cat(ys, dim=1)
    r = {"steps": S, "rel_err_y": rel_err(y, y_seq),
         "rel_err_state": rel_err(h, state),
         "max_abs_err_y": float((y - y_seq).abs().max())}
    r["ok"] = max(r["rel_err_y"], r["rel_err_state"]) <= RGLRU_SCAN_REL_TOL
    return r


def attention_replayed(params, cfg, batch) -> list:
    """A bf16 prefill through the kernel path with each attention layer's
    kernel output held against the blockwise attention of the same q, k
    and v (the kernel path's own activations at full width): the relative
    norm error of each layer, free of the differences earlier layers
    carry into the end-to-end comparison."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import forward_prefill
    from repro_torch.models.attention_flash import blockwise_attention
    kernel, errs = ops.flash_attention, []

    def replayed(q, k, v, n_kv, causal, window, prefix, bq, bk):
        out = kernel(q, k, v, n_kv, causal, window, prefix, bq, bk)
        errs.append(rel_err(out, blockwise_attention(
            q, k, v, n_kv, causal=causal, window=window, prefix=prefix,
            bq=bq, bk=bk)))
        return out
    ops.flash_attention = replayed
    try:
        with torch.no_grad():
            forward_prefill(params, cfg, batch,
                            pad_to=prompt_positions(cfg, batch) + SLICE_PAD)
    finally:
        ops.flash_attention = kernel
    return errs


def fp32_serving_checks(cfg, batch) -> dict:
    """A recurrent family's serving identities held in fp32 at full width
    and depth, where bf16 roundings, carried through the recurrent state
    and residual stream of every layer, grow past the limits (PERF.md):
    the params drawn again from the serving seed in fp32; decode at S
    against a prefill of S+1 at DECODE_REL_TOL; with attention layers, the
    kernel path's hidden state (the fp32 kernel) against the blockwise
    path's at HIDDEN_REL_TOL."""
    import torch
    from repro_torch.models import init_model
    from repro_torch.serve import make_decode_step, make_prefill_step
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg32, device="cuda")
    S = prompt_positions(cfg, batch)
    prefill = make_prefill_step(cfg32, pad_to=S + SLICE_PAD, device="cuda")
    logits, cache = prefill(params, batch)
    tok0 = _greedy(logits)
    _, decode0_logits, cache = make_decode_step(cfg32, device="cuda")(
        params, cache, tok0, S)
    del cache
    r = {"dtype": cfg32.param_dtype, "layers": cfg.n_layers,
         "decode_vs_prefill": decode_vs_prefill({
             "params": params, "batch": batch, "prefill": prefill,
             "tok0": tok0, "decode0_logits": decode0_logits})}
    hold(f"{cfg.name} fp32 decode at S vs prefill of S+1",
         r["decode_vs_prefill"]["rel_err"], DECODE_REL_TOL)
    if attn_layers(cfg):
        r["hidden_rel_err_vs_blockwise"] = hidden_vs_blockwise(
            params, cfg32, batch)
        hold(f"{cfg.name} fp32 kernel-path hidden state vs blockwise",
             r["hidden_rel_err_vs_blockwise"], HIDDEN_REL_TOL)
    del params
    torch.cuda.empty_cache()
    return r


def phase_ssm_serve() -> dict:
    """The SSM serving slice, mamba2-370m at full width and depth, through
    the port's entry points (``serve_main_path``: no kernel launch
    anywhere, there is no attention layer); decode at S against a prefill
    of S+1, reported in bf16 and held in fp32; one layer's chunked SSD
    against its sequential recurrence."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import layer
    cfg = get_arch(SSM_ARCH)
    st, r = serve_main_path(cfg)
    r["cache_bytes"] = sum(c.numel() * c.element_size()
                           for c in st.pop("cache").values())
    r["decode_vs_prefill_bf16"] = decode_vs_prefill(st)
    gen = torch.Generator(device="cuda").manual_seed(2)
    seq = ssd_chunked_vs_sequential(layer(st["params"]["blocks"], 0)["ssm"],
                                    cfg, gen)
    r["ssd_chunked_vs_sequential"] = seq
    batch = st["batch"]
    del st
    torch.cuda.empty_cache()
    if not seq["ok"]:
        fail(f"ssd_forward vs the sequential recurrence: {seq}")
    r["fp32"] = fp32_serving_checks(cfg, batch)
    r["decode_rel_tol"] = DECODE_REL_TOL
    return r


def phase_hybrid_serve() -> dict:
    """The hybrid serving slice, recurrentgemma-9b at full width and depth
    with ``flash_pallas``, through the port's entry points
    (``serve_main_path``: ``flash_fwd`` once a local-attention layer in the
    prefill, never in decode); each layer's kernel output against the
    blockwise attention of its own q, k, v in bf16; decode at S against a
    prefill of S+1 (S + steps stay inside the window, where the ring
    cache is exact), held in bf16 and in fp32; the kernel path's hidden
    state against the blockwise path's, reported in bf16 and held in
    fp32; one rec layer's log-depth scan against its sequential
    recurrence."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import layer
    cfg = dataclasses.replace(get_arch(HYBRID_ARCH), attn_impl="flash_pallas")
    if SLICE_PROMPT + SLICE_DECODE_STEPS > cfg.local_window:
        fail("the hybrid's serving run must stay inside its window")
    st, r = serve_main_path(cfg)
    r["cache_bytes"] = sum(c.numel() * c.element_size()
                           for c in st.pop("cache").values())
    params, batch = st["params"], st["batch"]
    r["flash_fwd_launches"] = sum(c["flash_fwd"]
                                  for c in r["launches"].values())
    replayed = attention_replayed(params, cfg, batch)
    r["attention_replayed_rel_err"] = replayed
    r["attention_replayed_rel_tol"] = BLOCK_REL_TOL["bfloat16"]
    r["hidden_rel_err_vs_blockwise_bf16"] = hidden_vs_blockwise(
        params, cfg, batch)
    r["decode_vs_prefill_bf16"] = decode_vs_prefill(st)
    gen = torch.Generator(device="cuda").manual_seed(3)
    scan = rglru_scan_vs_sequential(layer(params["rec_blocks"], 0)["rec"],
                                    cfg, gen)
    r["rglru_scan_vs_sequential"] = scan
    del st, params
    torch.cuda.empty_cache()
    if len(replayed) != attn_layers(cfg):
        fail(f"{cfg.name}: {len(replayed)} attention layers replayed")
    for i, e in enumerate(replayed):
        hold(f"{cfg.name} layer {i}'s kernel output vs blockwise on its "
             "own inputs", e, BLOCK_REL_TOL["bfloat16"])
    hold(f"{cfg.name} decode at S vs prefill of S+1",
         r["decode_vs_prefill_bf16"]["rel_err"], DECODE_REL_TOL)
    if not scan["ok"]:
        fail(f"the RG-LRU scan vs the sequential recurrence: {scan}")
    r["fp32"] = fp32_serving_checks(cfg, batch)
    r.update(hidden_rel_tol=HIDDEN_REL_TOL, decode_rel_tol=DECODE_REL_TOL)
    return r


def attention_serve(arch: str) -> dict:
    """An attention family's serving slice at full width and depth with
    ``flash_pallas``, through the port's entry points
    (``serve_main_path``: ``flash_fwd`` once an attention launch site a
    prefill, ``attn_layers``, never in decode); each launch's kernel output
    against the blockwise attention of its own q, k, v in bf16; the kernel
    path's hidden state against the blockwise path's; decode at S against
    a prefill of S+1."""
    import torch
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(arch), attn_impl="flash_pallas")
    st, r = serve_main_path(cfg)
    r["cache_bytes"] = sum(c.numel() * c.element_size()
                           for c in st.pop("cache").values())
    params, batch = st["params"], st["batch"]
    r["flash_fwd_launches"] = sum(c["flash_fwd"]
                                  for c in r["launches"].values())
    replayed = attention_replayed(params, cfg, batch)
    r["attention_replayed_max_rel_err"] = max(replayed)
    r["attention_replayed_rel_tol"] = BLOCK_REL_TOL["bfloat16"]
    r["hidden_rel_err_vs_blockwise"] = hidden_vs_blockwise(params, cfg,
                                                           batch)
    r["decode_vs_prefill"] = decode_vs_prefill(st)
    r.update(hidden_rel_tol=HIDDEN_REL_TOL, decode_rel_tol=DECODE_REL_TOL)
    del st, params
    torch.cuda.empty_cache()
    if len(replayed) != attn_layers(cfg):
        fail(f"{cfg.name}: {len(replayed)} attention launches replayed")
    for i, e in enumerate(replayed):
        hold(f"{cfg.name} attention launch {i}'s kernel output vs blockwise "
             "on its own inputs", e, BLOCK_REL_TOL["bfloat16"])
    hold(f"{cfg.name} kernel-path hidden state vs blockwise",
         r["hidden_rel_err_vs_blockwise"], HIDDEN_REL_TOL)
    hold(f"{cfg.name} decode at S vs prefill of S+1",
         r["decode_vs_prefill"]["rel_err"], DECODE_REL_TOL)
    return r


def phase_encdec_serve() -> dict:
    """The encoder-decoder serving slice, seamless-m4t-large-v2 at full
    width and depth: SLICE_PROMPT / 2 stub frames into the encoder and
    SLICE_PROMPT / 2 tokens into the decoder, 72 ``flash_fwd`` a prefill
    (24 encoder, 24 self, 24 cross), the decode identity's prefill of
    S+1 tokens running the cross-attention at 513 queries over 512 keys."""
    return attention_serve(ENCDEC_ARCH)


def phase_vlm_serve() -> dict:
    """The prefix-LM VLM serving slice, paligemma-3b at full width and
    depth: 256 stub patch embeddings and SLICE_PROMPT - 256 tokens, the
    prefix mask in each of the 18 ``flash_fwd`` launches of a prefill."""
    return attention_serve(VLM_ARCH)


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
    _hold_wgmma_route("offloaded session's prefill", launches["prefill"],
                      _routes())
    tok0 = _greedy(logits)
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
    want["prefill"]["flash_fwd"] = attn_layers(cfg)
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


def _watch_routes(fn, pick):
    """Run ``fn()``; return its result and ``pick(routing)`` of each
    ``moe.route`` call in it (one per MoE layer and pass)."""
    from repro_torch.models import moe
    route, seen = moe.route, []

    def watching_route(*a, **kw):
        r = route(*a, **kw)
        seen.append(pick(r))
        return r
    moe.route = watching_route
    try:
        return fn(), seen
    finally:
        moe.route = route


def _replay_routes(fn, experts):
    """Run ``fn()`` with the i-th ``moe.route`` call taking its choices from
    ``experts[i]`` (gates and slots from its own router probabilities)."""
    from repro_torch.models import moe
    route, it = moe.route, iter(experts)
    moe.route = lambda router, xf, k, capacity: moe.assign(
        moe.router_probs(router, xf), next(it), capacity)
    try:
        return fn()
    finally:
        moe.route = route


def _drop_fraction(r) -> float:
    """The share of (token, choice) pairs that lost their slot."""
    return float((~r.keep).float().mean())


def _apart(a, b) -> int:
    """Tokens whose set of experts differs between two routings."""
    return int((a.sort(dim=-1).values != b.sort(dim=-1).values)
               .any(-1).sum())


def moe_decode_vs_prefill(params, cfg, prompts) -> dict:
    """Decode at position S against the last row of a prefill of S+1
    tokens, at the no-drop capacity factor E/k (a token dropped in the
    prefill and kept in the decode would differ legitimately): the
    relative error of the logits and the greedy tokens' agreement, free
    (each path routes itself; per layer, the rows whose last token went
    to another set of experts) and with the decode's routing replayed
    from the prefill's last tokens, and the drop fraction of every layer
    in all three."""
    import torch
    from repro_torch.serve import make_decode_step, make_prefill_step
    B, S = prompts.shape
    cf = cfg.n_experts / cfg.experts_per_token
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    prefill = make_prefill_step(cfg, pad_to=S + SLICE_PAD, device="cuda")
    decode = make_decode_step(cfg, device="cuda")
    last = lambda r: r.expert.reshape(B, -1, r.expert.shape[-1])[:, -1]
    both = lambda r: (_drop_fraction(r), last(r))
    logits, cache = prefill(params, {"tokens": prompts})
    tok0 = _greedy(logits)
    cache2 = {n: c.clone() for n, c in cache.items()}
    (_, free, _), dec = _watch_routes(
        lambda: decode(params, cache, tok0, S), both)
    (full, _), pre = _watch_routes(lambda: prefill(params, {
        "tokens": torch.cat([prompts, tok0], dim=1)}), both)
    del cache
    (_, forced, _), rep = _watch_routes(lambda: _replay_routes(
        lambda: decode(params, cache2, tok0, S),
        [e[None] for _, e in pre]), _drop_fraction)
    del cache2
    agree = lambda lg: float((_greedy(lg) == _greedy(full)).float().mean())
    return {"capacity_factor": cf,
            "rel_err": rel_err(free[:, -1], full[:, -1]),
            "argmax_agree": agree(free),
            "rows_routed_apart": [_apart(a, b)
                                  for (_, a), (_, b) in zip(dec, pre)],
            "replayed_rel_err": rel_err(forced[:, -1], full[:, -1]),
            "replayed_argmax_agree": agree(forced),
            "drop_fractions": [d for d, _ in dec + pre] + rep}


def moe_mixture_check(lp: dict, cfg, gen) -> dict:
    """One layer's ``moe_ffn`` on MOE_MIX_TOKENS random tokens at the
    no-drop capacity factor E/k, in bf16 (the slice's path) and in fp32,
    against an explicit per-token mixture in fp32 from the same bf16
    weights: every expert's SwiGLU on every token, weighted by the
    renormalised top-k router probabilities (``torch.topk``'s set; the
    order does not enter the sum).  The bf16 path also runs twice and must
    give the same bits (no atomics in the gather dispatch and combine)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe
    d, E, k = cfg.d_model, cfg.n_experts, cfg.experts_per_token
    cfg16 = dataclasses.replace(cfg, capacity_factor=E / k)
    x = torch.randn((1, MOE_MIX_TOKENS, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        y16, _ = moe.moe_ffn(lp, x, cfg16)
        y16b, _ = moe.moe_ffn(lp, x, cfg16)
        lp32 = {n: w.float() for n, w in lp.items()}
        y32, _ = moe.moe_ffn(lp32, x.float(), dataclasses.replace(
            cfg16, param_dtype="float32"))
        xf = x.float().reshape(MOE_MIX_TOKENS, d)
        probs = torch.softmax(x.float() @ lp["router"], dim=-1)[0]
        topv, topi = torch.topk(probs, k, dim=-1)
        topv = topv / topv.sum(-1, keepdim=True)
        ref = torch.zeros_like(xf)
        for e in range(E):
            w = (topv * (topi == e)).sum(-1)
            if not bool(w.any()):
                continue
            h = F.silu(xf @ lp32["w_gate"][e]) * (xf @ lp32["w_up"][e])
            ref += w[:, None] * (h @ lp32["w_down"][e])
        del lp32
    scale = float(ref.abs().max())
    r = {"tokens": MOE_MIX_TOKENS, "capacity_factor": E / k,
         "experts_used": int(topi.unique().numel()),
         "bf16_rel_to_max": float((y16[0].float() - ref).abs().max())
         / scale,
         "fp32_rel_to_max": float((y32[0] - ref).abs().max()) / scale,
         "bf16_runs_bit_equal": torch.equal(y16, y16b), "ref_abs_max": scale}
    r["ok"] = (r["bf16_rel_to_max"] <= MOE_MIX_TOL["bfloat16"]
               and r["fp32_rel_to_max"] <= MOE_MIX_TOL["float32"]
               and r["bf16_runs_bit_equal"])
    return r


def phase_moe_serve() -> dict:
    """The MoE serving slice at full width through the port's entry points
    (``serve_main_path``): qwen3-moe-235b-a22b cut to MOE_SERVE_LAYERS
    layers at the default capacity factor; the drop fraction of each layer in that prefill and in a decode step;
    decode at S against a prefill of S+1 (``moe_decode_vs_prefill``) in
    bf16, held with the routing replayed, and at full width in fp32 over
    MOE_CHECK_LAYERS layers, held free and replayed; one layer's
    ``moe_ffn`` against the per-token mixture."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_model
    from repro_torch.models.transformer import layer

    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_SERVE_LAYERS,
                              attn_impl="flash_pallas")
    st, r = serve_main_path(cfg)
    params, prompts, cache = st["params"], st["prompts"], st.pop("cache")
    drops = {"prefill": _watch_routes(
                 lambda: st["prefill"](params, {"tokens": prompts}),
                 _drop_fraction)[1],
             "decode": _watch_routes(
                 lambda: st["decode"](params, cache, st["tok"],
                                      SLICE_PROMPT + SLICE_DECODE_STEPS),
                 _drop_fraction)[1]}
    del cache
    # the identity in bf16: held with the routing replayed, the free
    # reading reported (see MOE_CHECK_LAYERS)
    ident_bf16 = moe_decode_vs_prefill(params, cfg, prompts)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(1)
    mix = moe_mixture_check(layer(params["blocks"], 0)["moe"], cfg, gen)
    r.update({"capacity_factor": cfg.capacity_factor,
              "drop_fraction_per_layer": drops,
              "decode_vs_prefill_bf16": ident_bf16, "mixture": mix})
    del params, st
    torch.cuda.empty_cache()

    # the identity held free and replayed: full width, MOE_CHECK_LAYERS
    # layers, fp32
    cfg32 = dataclasses.replace(cfg, n_layers=MOE_CHECK_LAYERS,
                                param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg32, device="cuda")
    ident = moe_decode_vs_prefill(params, cfg32, prompts)
    ident.update(layers=cfg32.n_layers, dtype=cfg32.param_dtype)
    r["decode_vs_prefill"] = ident
    del params
    torch.cuda.empty_cache()
    print(json.dumps({"moe_serve_checks": r}))
    for name, i in (("bf16", ident_bf16), ("fp32", ident)):
        if any(i["drop_fractions"]):
            fail(f"MoE serving ({name}) dropped tokens at capacity factor "
                 f"{i['capacity_factor']}: {i['drop_fractions']}")
    held = [ident["rel_err"], ident["replayed_rel_err"],
            ident_bf16["replayed_rel_err"]]
    if not all(math.isfinite(e) and e <= DECODE_REL_TOL for e in held):
        fail(f"MoE decode at S vs prefill of S+1: bf16 {ident_bf16}, "
             f"fp32 {ident}")
    if not mix["ok"]:
        fail(f"moe_ffn vs the per-token mixture: {mix}")
    return r


def _counters():
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import shard_pack as sp
    return {"flash_fwd": fa.LAUNCHES, "flash_bwd_dq": fa.BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES,
            "quantize": qz.QUANT_LAUNCHES, "dequantize": qz.DEQUANT_LAUNCHES,
            "checksum": ck.CHECKSUM_LAUNCHES, "shard_pack": sp.PACK_LAUNCHES,
            "shard_unpack": sp.UNPACK_LAUNCHES,
            "decode_attn": da.DECODE_ATTN_LAUNCHES}


def _zero_counters() -> None:
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import shard_pack as sp
    fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    for route in ROUTES:
        fa.FWD_ROUTE_LAUNCHES[route] = fa.BWD_ROUTE_LAUNCHES[route] = 0
    qz.QUANT_LAUNCHES = qz.DEQUANT_LAUNCHES = 0
    ck.CHECKSUM_LAUNCHES = sp.PACK_LAUNCHES = sp.UNPACK_LAUNCHES = 0
    da.DECODE_ATTN_LAUNCHES = 0
    for route in DECODE_ROUTES:
        da.ROUTE_LAUNCHES[route] = 0


def _routes() -> dict:
    """The forward's launches and the backward's passes by route since the
    counters were set to 0."""
    from repro_torch.kernels import flash_attention as fa
    return {"fwd": dict(fa.FWD_ROUTE_LAUNCHES),
            "bwd": dict(fa.BWD_ROUTE_LAUNCHES)}


def _hold_wgmma_route(what: str, launches: dict, routes: dict) -> None:
    """Every forward launch and every backward pass (dq and dk/dv) counted
    in ``launches`` took the wgmma route, by the route counters read with
    them."""
    on_wgmma = lambda n: {"wgmma": n, "mma": 0, "fp32": 0}
    want = {"fwd": on_wgmma(launches["flash_fwd"]),
            "bwd": on_wgmma(launches["flash_bwd_dq"]
                            + launches["flash_bwd_dkv"])}
    if routes != want:
        fail(f"{what}: launches by route {routes}, want {want}")


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
        if device == "cuda":
            _hold_wgmma_route("checkpointed training", launches, _routes())
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
            "shard_pack": 0, "shard_unpack": 0, "decode_attn": 0}
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


def train_model_flops(cfg, params) -> float:
    """Model FLOPs of one training step (no recompute): 6 per matmul weight
    a token passes through (the token-embedding lookup is no product; of a
    MoE layer's experts only the k routed ones, never all E), plus the
    sequence-mixing products, x3 with the backward: attention 4 B H D a
    (query, key) pair an attention layer forward, over the S(S+1)/2 causal
    pairs or, under a window W (the hybrid's local layers), W(W+1)/2 +
    (S-W) W, or with a prefix P the P(P-1)/2 more it opens; the SSD's
    intra-chunk products 2 B S Q (N + H P) and its chunk-state and
    inter-chunk products 2 x 2 B S H N P a layer.  The budget of
    TRAIN_SEQ positions splits as ``model_inputs`` splits it: the VLM's
    head runs on its text positions only; the encoder-decoder's encoder
    weights and its cross-attention's k/v projections see the Se frames,
    the rest of the decoder and the head the Sd tokens, over Se^2
    bidirectional encoder pairs, Sd(Sd+1)/2 causal and Sd Se cross pairs
    a layer.  Params are counted from the tree: ``ModelConfig.n_params()``
    leaves out every family's untied head and the RG-LRU's w_r and w_i
    (recurrentgemma-9b: 1.92e9 of its 10.44e9)."""
    from repro_torch.models import param_count, text_len
    from repro_torch.models.ssm import chunk_len
    B, S = TRAIN_BATCH, TRAIN_SEQ
    head = cfg.d_model * cfg.padded_vocab()
    per_pair = 4.0 * B * cfg.n_heads * cfg.head_dim
    if cfg.family == "encdec":
        Sd = text_len(cfg, S)
        Se = S - Sd
        xkv = sum(params["decoder"]["xattn"][w].numel() for w in ("wk", "wv"))
        enc = param_count(params["encoder"]) + xkv
        dec = param_count(params["decoder"]) - xkv + head
        pairs = cfg.enc_layers * Se * Se + cfg.dec_layers * (
            Sd * (Sd + 1) / 2 + Sd * Se)
        return 6.0 * B * (enc * Se + dec * Sd) + 3.0 * per_pair * pairs
    active = param_count(params) - cfg.padded_vocab() * cfg.d_model
    if cfg.family == "moe":
        active -= cfg.n_layers * (cfg.n_experts - cfg.experts_per_token) \
            * 3 * cfg.d_model * cfg.d_ff
    dense = 6.0 * active * B * S
    if cfg.family == "vlm":          # the head sees the text only
        dense -= 6.0 * head * B * (S - text_len(cfg, S))
    if cfg.family == "ssm":
        H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
        Q = chunk_len(S, cfg.ssm_chunk)
        mix = cfg.n_layers * (2.0 * B * S * Q * (N + H * P)
                              + 2 * 2.0 * B * S * H * N * P)
    else:
        W = cfg.local_window if cfg.family == "hybrid" else cfg.swa_window
        pairs = S * (S + 1) / 2 if not W or S <= W \
            else W * (W + 1) / 2 + (S - W) * W
        P = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
        pairs += P * (P - 1) / 2
        mix = attn_layers(cfg) * per_pair * pairs
    return dense + 3.0 * mix


def kernel_vs_plain(params, cfg, batch, hold_leaves: bool = True) -> dict:
    """The kernel path's loss, grad norm and per-leaf gradients against the
    plain path's (``attn_impl="flash"``) from the same params and batch,
    held at TRAIN_LOSS_REL_TOL, TRAIN_GNORM_REL_TOL and, with
    ``hold_leaves``, TRAIN_LEAF_REL_TOL (MoE: each leaf with the kernel
    path's routing replayed).  The kernel path's grads wait on the host
    while the plain path runs."""
    from repro_torch.train import global_norm, loss_and_grads
    from repro_torch.tree import tree_items
    (loss_k, aux_k, grads), experts = _watch_routes(
        lambda: loss_and_grads(params, cfg, batch), lambda r: r.expert)
    gnorm_k = float(global_norm(grads))
    grads_k = {name: g.cpu() for name, g in tree_items(grads)}
    del grads
    plain = dataclasses.replace(cfg, attn_impl="flash")

    def against_kernel(run) -> dict:
        loss_p, aux_p, grads = run()
        gnorm_p = float(global_norm(grads))
        leaf_rel = {}
        for name, g in tree_items(grads):
            gk = grads_k[name].to("cuda")
            leaf_rel[name] = float((gk.float() - g.float()).norm()
                                   / g.float().norm())
            del gk
        del grads
        return {"loss_plain": float(loss_p), "aux_plain": float(aux_p),
                "loss_rel": abs(float(loss_k) - float(loss_p))
                / abs(float(loss_p)),
                "grad_norm_plain": gnorm_p,
                "grad_norm_rel": abs(gnorm_k - gnorm_p) / gnorm_p,
                "leaf_rel": leaf_rel}

    (free, experts_p) = _watch_routes(lambda: against_kernel(
        lambda: loss_and_grads(params, plain, batch)), lambda r: r.expert)
    free["tokens_routed_apart"] = [_apart(a, b)
                                   for a, b in zip(experts, experts_p)]
    cmp = {"free": free}
    if experts:     # MoE: each leaf held with the kernel path's routing
        cmp["replayed"] = against_kernel(lambda: _replay_routes(
            lambda: loss_and_grads(params, plain, batch), experts))
    del grads_k
    held = cmp.get("replayed", free)
    print(json.dumps({"train_kernel_vs_plain": {
        "arch": cfg.name, "dtype": cfg.param_dtype,
        "loss_kernel": float(loss_k), "aux_kernel": float(aux_k),
        "grad_norm_kernel": gnorm_k, "leaves_held": hold_leaves, **cmp}}))
    if not (all(c["loss_rel"] <= TRAIN_LOSS_REL_TOL
                and c["grad_norm_rel"] <= TRAIN_GNORM_REL_TOL
                for c in cmp.values())
            and all(math.isfinite(v) and (v <= TRAIN_LEAF_REL_TOL
                                          or not hold_leaves)
                    for v in held["leaf_rel"].values())):
        fail(f"{cfg.name} training kernel path vs plain path out of its "
             "limits")
    return cmp



def run_train(cfg, fp32_leaves: bool = False) -> dict:
    """A training slice at full width through ``make_train_step``: the
    kernel path's loss, grad norm and per-leaf gradients against the plain
    path's from the same params and batch (where the model has attention
    layers; with ``fp32_leaves`` the leaves are reported in bf16 and held
    with both paths in fp32, from the same params widened), then one
    warm-up step and TRAIN_TIMED_STEPS timed ones with every launch
    counter set to 0 just before and read just after (exact counts), and
    the loss must fall."""
    import torch
    from repro_torch.kernels.quantize import BLOCK_GROUPS, GROUP
    from repro_torch.models import init_model, param_count
    from repro_torch.train import make_eval_step, make_train_step, opt_init
    from repro_torch.tree import tree_leaves, tree_map

    B, S = TRAIN_BATCH, TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg, device="cuda")
    batch = model_inputs(cfg, gen, B, S)
    n_params = param_count(params)
    # leaves the int8 compression quantizes (smaller ones pass as they are)
    n_big = sum(1 for p in tree_leaves(params)
                if p.numel() >= GROUP * BLOCK_GROUPS)

    n_attn = attn_layers(cfg)
    cmp = {} if n_attn == 0 else kernel_vs_plain(
        params, cfg, batch, hold_leaves=not fp32_leaves)
    torch.cuda.empty_cache()
    if n_attn and fp32_leaves:
        widen = lambda t: t.float() if t.is_floating_point() else t
        cmp["fp32"] = kernel_vs_plain(
            tree_map(widen, params),
            dataclasses.replace(cfg, param_dtype="float32"),
            {k: widen(v) for k, v in batch.items()})["free"]
        torch.cuda.empty_cache()

    state = opt_init(cfg.optimizer, params)
    step = make_train_step(cfg, device="cuda")
    params, state, m0 = step(params, state, batch)          # warm-up
    first_loss = float(m0["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9

    # the main path: counts to 0, 3 steps, counts read
    _zero_counters()
    losses, norms, auxes = [], [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        auxes.append(m["aux_loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
    launches = _counters()
    routes = _routes()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    auxes = [float(x) for x in auxes]
    after = float(make_eval_step(cfg, device="cuda")(params, batch))
    # the same steps with the backward, then the forward, on the mma
    # route's kernels, on the same card (after the checks; the params go
    # on training)
    from repro_torch.kernels import flash_attention as fa
    mma_step_ms = {}
    for which in ("bwd", "fwd") if n_attn else ():
        with forced_route(fa, "mma", which):
            params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_TIMED_STEPS):
                params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
        mma_step_ms[which] = (time.perf_counter() - t0) * 1e3 \
            / TRAIN_TIMED_STEPS
    # the kernel path again, after the forced runs: the drift between
    # the first and last readings bounds what the comparison can show
    step_ms_again = None
    if n_attn:
        t0 = time.perf_counter()
        for _ in range(TRAIN_TIMED_STEPS):
            params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        step_ms_again = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS

    L = cfg.n_layers
    n = TRAIN_TIMED_STEPS
    # remat runs each attention layer's forward kernel twice
    want = {"flash_fwd": 2 * n_attn * n, "flash_bwd_dq": n_attn * n,
            "flash_bwd_dkv": n_attn * n, "quantize": n_big * n,
            "dequantize": n_big * n, "checksum": 0, "shard_pack": 0,
            "shard_unpack": 0, "decode_attn": 0}
    if launches != want:
        fail(f"{cfg.name} training launches {launches}, want {want}")
    _hold_wgmma_route(f"{cfg.name} training", launches, routes)
    if not all(math.isfinite(x) for x in [first_loss, after, *losses,
                                          *norms, *auxes]):
        fail(f"non-finite training loss, grad norm or aux loss: {losses} "
             f"{norms} {auxes}")
    if not after < first_loss:
        fail(f"loss did not fall: first step {first_loss}, after "
             f"{n} more steps {after}")
    flops = train_model_flops(cfg, params)
    del params, state
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": L, "params": n_params,
            "dtype": cfg.param_dtype, "optimizer": cfg.optimizer,
            "grad_compression": cfg.grad_compression, "remat": cfg.remat,
            "attn_impl": cfg.attn_impl, "batch": B, "seq": S,
            "inputs": {k: list(v.shape) for k, v in batch.items()},
            "timed_steps": n, "first_loss": first_loss,
            "step_losses": losses, "grad_norms": norms, "aux_losses": auxes,
            "loss_after": after, "step_ms": step_ms,
            "step_ms_mma_bwd": mma_step_ms.get("bwd"),
            "step_ms_mma_fwd": mma_step_ms.get("fwd"),
            "step_ms_again": step_ms_again,
            "tokens_per_s": B * S / (step_ms / 1e3), "peak_mem_gb": peak_gb,
            "resident_gb": resident_gb, "model_flops_per_step": flops,
            "mfu": flops / (step_ms / 1e3) / BF16_FLOP_PER_S,
            "launches": launches, "fwd_routes": routes["fwd"],
            "bwd_routes": routes["bwd"],
            "compressed_leaves": n_big,
            "kernel_vs_plain": {
                name: {"loss_rel": c["loss_rel"],
                       "grad_norm_rel": c["grad_norm_rel"],
                       "max_leaf_rel": max(c["leaf_rel"].values())}
                for name, c in cmp.items()}}


def train_slice_cfg(name: str):
    """The config each training phase runs (and ``phase_dryrun`` counts):
    full width, int8 compression and remat, the kernel path where there
    is attention, Adafactor where AdamW's moments do not fit, the depth
    cut where the card needs it."""
    from repro_torch.configs import get_arch
    kw = dict(attn_impl="flash_pallas", grad_compression=True, remat=True)
    arch, extra = {
        "train": (SLICE_ARCH, dict(optimizer="adafactor")),
        "moe_train": (MOE_ARCH, dict(n_layers=MOE_TRAIN_LAYERS,
                                     optimizer="adafactor")),
        "ssm_train": (SSM_ARCH, dict(optimizer="adafactor")),
        "hybrid_train": (HYBRID_ARCH, dict(n_layers=HYBRID_TRAIN_LAYERS,
                                           optimizer="adafactor")),
        "encdec_train": (ENCDEC_ARCH, {}),
        "vlm_train": (VLM_ARCH, {})}[name]
    if name == "ssm_train":     # no attention: the config's own attn_impl
        del kw["attn_impl"]
    return dataclasses.replace(get_arch(arch), **kw, **extra)


def phase_train() -> dict:
    """The training slice: deepseek-7b at full width and depth."""
    return run_train(train_slice_cfg("train"))


def phase_moe_train() -> dict:
    """The MoE training slice: qwen3-moe-235b-a22b at full width, its depth
    cut to MOE_TRAIN_LAYERS, with the training slice's settings; the aux
    loss must be finite and positive."""
    r = run_train(train_slice_cfg("moe_train"))
    if not all(a > 0 for a in r["aux_losses"]):
        fail(f"MoE aux loss not positive: {r['aux_losses']}")
    return r


def phase_encdec_train() -> dict:
    """The encoder-decoder training slice: seamless-m4t-large-v2 at full
    width and depth, TRAIN_SEQ / 2 frames and TRAIN_SEQ / 2 tokens, with
    its config's AdamW, int8 compression and remat (144 ``flash_fwd``, 72
    dq and 72 dk/dv a step; the gradient of the encoder's output summed
    over the 24 cross-attention layers); the per-leaf gradients held in
    fp32 (see TRAIN_LEAF_REL_TOL)."""
    return run_train(train_slice_cfg("encdec_train"), fp32_leaves=True)


def phase_vlm_train() -> dict:
    """The VLM training slice: paligemma-3b at full width and depth, 256
    patches and TRAIN_SEQ - 256 tokens (the loss on the text positions),
    with its config's AdamW, int8 compression and remat."""
    return run_train(train_slice_cfg("vlm_train"))


def ssm_layer_grads_card_vs_host(cfg, gen) -> dict:
    """One SSM layer at full width in fp32 (fresh params from ``gen``), its
    parameter gradients of a random linear function of ``ssd_forward``'s
    output and final state over one TRAIN_SEQ row, on the card against
    the same computation on the host CPU from the same numbers (the
    reference here; summation order only), per leaf at SSM_GRAD_REL_TOL."""
    import torch
    from repro_torch.models import ssm
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    p = ssm.init_ssm(gen, cfg32)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device="cuda")
    wy = torch.randn(x.shape, generator=gen, device="cuda")
    ws = torch.randn((1, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                     generator=gen, device="cuda")

    def grads(device) -> dict:
        pp = {n: w.detach().to(device).requires_grad_()
              for n, w in p.items()}
        y, st, _ = ssm.ssd_forward(pp, x.to(device), cfg32)
        ((y * wy.to(device)).sum() + (st * ws.to(device)).sum()).backward()
        return {n: w.grad.cpu() for n, w in pp.items()}

    card, host = grads("cuda"), grads("cpu")
    rel = {n: rel_err(card[n], host[n]) for n in card}
    return {"seq": TRAIN_SEQ, "leaf_rel": rel,
            "ok": all(math.isfinite(v) and v <= SSM_GRAD_REL_TOL
                      for v in rel.values())}


def phase_ssm_train() -> dict:
    """The SSM training slice, mamba2-370m at full width and depth with
    the training slice's settings (no attention layer, so no
    kernel-vs-plain comparison: its kernels are the int8 compression's);
    then one layer's gradients on the card against the host's."""
    import torch
    cfg = train_slice_cfg("ssm_train")
    r = run_train(cfg)
    g = ssm_layer_grads_card_vs_host(
        cfg, torch.Generator(device="cuda").manual_seed(4))
    r["ssm_layer_grads_card_vs_host"] = g
    torch.cuda.empty_cache()
    if not g["ok"]:
        fail(f"SSM layer gradients, card vs host: {g}")
    return r


def phase_hybrid_train() -> dict:
    """The hybrid training slice: recurrentgemma-9b at full width, its
    depth cut to HYBRID_TRAIN_LAYERS, with the training slice's settings
    (the local attention through the flash kernels, window biting at
    S = 4096)."""
    return run_train(train_slice_cfg("hybrid_train"))


def dryrun_prefill_on_card() -> dict:
    """The dry-run's prefill cell run on the card: DRYRUN_PREFILL at full
    width and depth through ``make_prefill_step`` (no cache padding, as the
    dry-run builds it), ``flash_pallas``; after a warm-up, the peak
    statistics reset and every launch counter set to 0 just before one
    prefill and read just after (one ``flash_fwd`` a layer, nothing
    else); the logits must be finite."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_model
    from repro_torch.serve import make_prefill_step
    arch, B, S = DRYRUN_PREFILL
    cfg = dataclasses.replace(get_arch(arch), attn_impl="flash_pallas")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg, device="cuda")
    batch = model_inputs(cfg, gen, B, S)
    prefill = make_prefill_step(cfg, device="cuda")
    out = prefill(params, batch)                       # warm-up
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    _zero_counters()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = _counters()
    _hold_wgmma_route("dry-run prefill", launches, _routes())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in launches}
    want["flash_fwd"] = attn_layers(cfg)
    if launches != want:
        fail(f"dry-run prefill launches {launches}, want {want}")
    if not bool(torch.isfinite(logits).all()):
        fail("dry-run prefill: non-finite logits")
    del params, batch, logits, cache
    torch.cuda.empty_cache()
    return {"cfg": cfg, "batch": B, "seq": S, "peak_mem_gb": peak_gb,
            "resident_gb": resident_gb, "prefill_ms": prefill_ms,
            "launches": launches}


def _dryrun_reading(cfg, kind: str, B: int, S: int, run: dict,
                    model_flops: float | None) -> dict:
    """The dry-run's count of one cell on the meta device beside the card's
    reading of the same step: predicted peak (argument + temporary bytes)
    against ``max_memory_allocated``, the counted FLOPs against the
    model's, and the count's host seconds."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    res = dryrun.run_cell(cfg, ShapeConfig(f"card_{kind}", S, B, kind),
                          tag="chip_smoke", verbose=False)
    mem = res["memory"]
    pred = mem["peak_bytes"] / 1e9
    flops = res["per_device"]["flops"]
    model = model_flops if model_flops is not None \
        else res["model_flops_tree"]
    return {"arch": cfg.name, "layers": cfg.n_layers, "kind": kind,
            "batch": B, "seq": S, "optimizer": cfg.optimizer,
            "predicted_peak_gb": pred, "card_peak_gb": run["peak_mem_gb"],
            "peak_rel_err": (pred - run["peak_mem_gb"])
            / run["peak_mem_gb"],
            "argument_gb": mem["argument_bytes"] / 1e9,
            "temp_gb": mem["temp_bytes"] / 1e9,
            "card_resident_gb": run["resident_gb"],
            "own_err_gb": mem["temp_bytes"] / 1e9
            - (run["peak_mem_gb"] - run["resident_gb"]),
            "counted_flops": flops, "model_flops": model,
            "flops_ratio": flops / model, "eager_bytes":
            res["per_device"]["bytes"], "n_ops": res["per_device"]["n_ops"],
            "roofline": res["roofline"], "count_wall_s": res["count_wall_s"],
            "counted_on": res["counted_on"], "peaks_of": res["peaks_of"]}


def op_host_us(iters: int = 200) -> dict:
    """Host microseconds a ``flash_fwd`` call takes through the wrapper
    itself and through the port's op (``flash_fwd_op``: a schema defined
    with ``torch.library.Library``, the wrapper its CPU and CUDA kernel, as
    the model reaches it), at a small bf16 case where the launch is most of
    the work (one head, 128 queries and keys, D = 128): the least of two
    runs of ``iters`` calls each, ending in a synchronise, in turns."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((1, 1, 1, 128, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn((1, 1, 128, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    scale = 128 ** -0.5
    calls = {"wrapper": lambda: fa.flash_fwd(q, k, k, scale=scale),
             "port_op": lambda: fa.flash_fwd_op(q, k, k, True, 0, 0, scale)}

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / iters

    got = {name: [] for name in calls}
    for name in (*calls, *reversed(calls)):
        got[name].append(host_us(calls[name]))
    return {f"{name}_us": min(v) for name, v in got.items()}


def phase_dryrun(train_runs: dict) -> dict:
    """The dry-run's predictions held against the card.  Each training
    slice that ran above (``train_slice_cfg``: the same config, depth cut,
    batch, sequence, optimizer, int8 compression, remat and
    ``flash_pallas``) is counted by ``repro_torch.launch.dryrun`` on the
    meta device, and so is DRYRUN_PREFILL, which runs on the card here
    (``dryrun_prefill_on_card``).  Each predicted peak must lie within
    DRYRUN_PEAK_REL_TOL of the card's, and the step's own bytes within
    DRYRUN_OWN_ABS_TOL_GB; the counted FLOPs are printed
    against the model FLOPs (``train_model_flops``; for the prefill,
    2 x the tree's params a token), a ratio >= 1 where remat recomputes the
    forward and MoE computes padded capacity slots.  The counts run on
    the meta device and launch nothing: every counter stays 0."""
    prefill = dryrun_prefill_on_card()
    _zero_counters()
    out = {name: _dryrun_reading(train_slice_cfg(name), "train",
                                 TRAIN_BATCH, TRAIN_SEQ, run,
                                 run["model_flops_per_step"])
           for name, run in train_runs.items()}
    out["prefill"] = _dryrun_reading(prefill["cfg"], "prefill",
                                     prefill["batch"], prefill["seq"],
                                     prefill, None)
    counted = _counters()
    if any(counted.values()):
        fail(f"the dry-run's counts launched kernels: {counted}")
    out["prefill"].update(card_prefill_ms=prefill["prefill_ms"],
                          launches=prefill["launches"])
    for name, r in out.items():
        print(json.dumps({"dryrun_vs_card": {name: r}}))
        hold(f"{name}: dry-run peak vs the card's", abs(r["peak_rel_err"]),
             DRYRUN_PEAK_REL_TOL)
        hold(f"{name}: dry-run's temporary GB vs the card's step",
             abs(r["own_err_gb"]), DRYRUN_OWN_ABS_TOL_GB)
    print(json.dumps({"op_host_us": op_host_us()}))
    return out


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over HBM's rate."""
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sdpa_backend(fn) -> dict:
    """The backend a scaled_dot_product_attention call takes, read from
    the names of the kernels it launches (torch.profiler): cudnn, flash,
    efficient (the CUTLASS fmha kernels) or math."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA})
    low = " ".join(names).lower()
    backend = next((b for b, keys in (("cudnn", ("cudnn",)),
                                      ("flash", ("flash",)),
                                      ("efficient", ("fmha", "efficient")))
                    if any(k in low for k in keys)), "math")
    return {"backend": backend, "kernels": [n[:100] for n in names]}


def attn_times(case, iters: int, plain_iters: int, bwd: bool) -> dict:
    """flash_fwd at ``case`` (bf16, the case's mask) and, with ``bwd``, the
    dq + dk/dv pair fed the forward kernel's own ``out`` and ``lse``: each
    beside its bound, its plain twin and scaled_dot_product_attention
    (timed as a yardstick only; ``enable_gqa`` where G > 1, an explicit
    boolean mask under a window or prefix, and the backend it takes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S, Hq, n_kv, D = case[:5]
    mask = case_mask(case)
    gen = torch.Generator(device="cuda").manual_seed(12)
    (q, k, v), (q5, k4, v4) = make_qkv(case, torch.bfloat16, gen)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    allow = fa._allow(S, case_sk(case), **mask, device="cuda")
    sdpa_kw = dict(enable_gqa=True) if n_kv < Hq else {}
    if mask["window"] or mask["prefix"]:
        sdpa_kw["attn_mask"] = allow
    else:
        sdpa_kw["is_causal"] = mask["causal"]
    fwd = lambda: fa.flash_fwd(q5, k4, v4, **mask)
    before = dict(fa.FWD_ROUTE_LAUNCHES)
    fwd()
    r = {"fwd_route": moved_route(fa.FWD_ROUTE_LAUNCHES, before, 1),
         "ms": cuda_ms(fwd, iters=iters)}
    # the kernel's own device time (the profiler's): at the smallest
    # shapes the wrapper's host time exceeds the kernel's, and the events
    # around back-to-back calls then read the host
    name = (WGMMA_KERNELS if r["fwd_route"] == "wgmma"
            else TC_KERNELS)["flash_fwd"][0]
    r["device_ms"] = _profiled_ms(fwd, (name,))[name]
    # the mma route's kernel (mma.sync) on the same inputs and card
    with forced_route(fa, "mma", "fwd"):
        r["mma_ms"] = cuda_ms(fwd, iters=iters)
        name = TC_KERNELS["flash_fwd"][0]
        r["mma_device_ms"] = _profiled_ms(fwd, (name,))[name]
    r["plain_ms"] = cuda_ms(lambda: fa.flash_fwd_reference(
        q5, k4, v4, **mask), iters=plain_iters)
    with torch.no_grad():
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, **sdpa_kw)
        r["library_ms"] = cuda_ms(sdpa, iters=iters)
        r["library_backend"] = sdpa_backend(sdpa)
    # the (query, key) pairs this mask allows (causal: S(S+1)/2 per q
    # head), each product one multiply-add over D; q/k/v/dO/out/dq/dk/dv
    # (bf16) and lse/delta (fp32) read or written once
    prod = 2.0 * B * Hq * D * fa.allowed_pairs(S, case_sk(case), **mask)
    nq, nkv, rows = q.numel() * 2, k.numel() * 2, 4 * B * Hq * S
    r["bound_ms"], r["bound_by"] = _bound(2 * prod, 2 * nq + 2 * nkv + rows)
    r["flops"], r["bytes"] = 2 * prod, 2 * nq + 2 * nkv + rows
    r["tflops_per_s"] = 2 * prod / (r["ms"] / 1e3) / 1e12
    if not bwd:
        return r
    do = torch.randn(q.shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    do5 = do.reshape(B, S, n_kv, Hq // n_kv, D).permute(0, 2, 3, 1, 4)
    out5, lse = fa.flash_fwd(q5, k4, v4, **mask)
    delta = (do5.float() * out5.float()).sum(-1)
    pair = lambda: fa.flash_bwd(q5, k4, v4, do5, lse, delta, **mask)
    before = dict(fa.BWD_ROUTE_LAUNCHES)
    r["pair_ms"] = cuda_ms(pair, iters=5)
    r["route"] = next(k for k in before
                      if fa.BWD_ROUTE_LAUNCHES[k] > before[k])
    names = (WGMMA_KERNELS if r["route"] == "wgmma"
             else TC_KERNELS)["flash_bwd"]
    per = _profiled_ms(pair, names, optional=(REDUCE_KERNEL,))
    # the mma route's kernels (mma.sync) on the same inputs and card
    with forced_route(fa, "mma", "bwd"):
        r["mma_pair_ms"] = cuda_ms(pair, iters=5)
        mma = _profiled_ms(pair, TC_KERNELS["flash_bwd"])
    r["mma_dq_ms"], r["mma_dkv_ms"] = (mma[k] for k in
                                       TC_KERNELS["flash_bwd"])
    r["plain_pair_ms"] = cuda_ms(lambda: fa.flash_bwd_reference(
        q5, k4, v4, do5, lse, delta, **mask), iters=2, warmup=1)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)
    doh = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), doh,
                                           retain_graph=True)
    r["library_pair_ms"] = cuda_ms(sdpa_bwd, iters=5)
    r["library_pair_backend"] = sdpa_backend(sdpa_bwd)
    # dq does 3 products (q.k, dO.v, ds.k), dk/dv 4, the pair only 5
    reads = 2 * nq + 2 * nkv + 2 * rows
    for name, n_prod, written in (("dq", 3, nq), ("dkv", 4, 2 * nkv),
                                  ("pair", 5, nq + 2 * nkv)):
        bound, by = _bound(n_prod * prod, reads + written)
        r[f"{name}_bound_ms"], r[f"{name}_bound_by"] = bound, by
    # the dk/dv pass: its kernel and, with the groups chunked, the sum
    r["dq_ms"] = per[names[0]]
    r["dkv_ms"] = per[names[1]] + per[REDUCE_KERNEL]
    r["dkv_reduce_ms"] = per[REDUCE_KERNEL]
    r["dkv_chunks"] = fa._dkv_chunks(B, n_kv, Hq // n_kv, case_sk(case), D) \
        if r["route"] == "wgmma" else 1
    del q, k, v, do, q5, k4, v4, do5, out5, lse, delta, qg, kg, vg
    del sdpa_out, doh, allow
    torch.cuda.empty_cache()
    return r


def phase_kernel_times() -> dict:
    """flash_fwd at the serving slice's shape (bf16, causal): kernel, plain
    version, scaled_dot_product_attention and the bound."""
    return attn_times(KERNEL_CASES[-1], iters=20, plain_iters=5, bwd=False)


def phase_moe_kernel_times() -> dict:
    """flash_fwd and the backward pair at the MoE slices' GQA shapes (64 q
    heads over 4 KV heads, G = 16): serving (B=4 x 1024) and training
    (B=2 x 4096)."""
    return {"serve_shape": attn_times(MOE_SERVE_CASE, iters=20,
                                      plain_iters=5, bwd=True),
            "train_shape": attn_times(MOE_TRAIN_CASE, iters=5, plain_iters=2,
                                      bwd=True)}


def phase_hybrid_kernel_times() -> dict:
    """flash_fwd and the backward pair at the hybrid's local-attention
    shapes (16 q heads over 1 KV head of 256, G = 16, window 2048):
    serving (B=4 x 1024, the window does not bite) and training (B=2 x
    4096, it does)."""
    return {"serve_shape": attn_times(HYBRID_SERVE_CASE, iters=20,
                                      plain_iters=5, bwd=True),
            "train_shape": attn_times(HYBRID_TRAIN_CASE, iters=5,
                                      plain_iters=2, bwd=True)}


def phase_encdec_kernel_times() -> dict:
    """flash_fwd and the backward pair at the encoder-decoder's D = 64
    shapes (16 MHA heads): the decoder's causal self-attention serving
    (B=4 x 512) and training (B=2 x 2048), the bidirectional encoder and
    cross-attention training (B=2 x 2048); and the forward of the decode
    identity's cross-attention, 513 queries over 512 keys."""
    return {"serve_shape": attn_times(ENCDEC_SERVE_CASE, iters=20,
                                      plain_iters=5, bwd=True),
            "train_shape": attn_times(ENCDEC_TRAIN_CASE, iters=5,
                                      plain_iters=2, bwd=True),
            "bidir_train_shape": attn_times(ENCDEC_BIDIR_TRAIN_CASE,
                                            iters=5, plain_iters=2,
                                            bwd=True),
            "cross_shape": attn_times(ENCDEC_CROSS_CASE, iters=20,
                                      plain_iters=5, bwd=False)}


def phase_vlm_kernel_times() -> dict:
    """flash_fwd and the backward pair at the VLM's shapes (8 q heads over
    1 KV head of 256, G = 8, causal with a 256-position prefix): serving
    (B=4 x 1024) and training (B=2 x 4096)."""
    return {"serve_shape": attn_times(VLM_SERVE_CASE, iters=20,
                                      plain_iters=5, bwd=True),
            "train_shape": attn_times(VLM_TRAIN_CASE, iters=5, plain_iters=2,
                                      bwd=True)}


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


def forced_route(fa, route: str, *passes: str):
    """A context in which the named passes ("fwd": ``flash_fwd``, "bwd":
    ``flash_bwd``) take ``route`` whatever their inputs (``_fwd_route``,
    ``_bwd_route`` replaced), to time one design against another on the
    same inputs; for measurement only."""
    import contextlib
    names = [{"fwd": "_fwd_route", "bwd": "_bwd_route"}[p] for p in passes]

    @contextlib.contextmanager
    def ctx():
        real = {n: getattr(fa, n) for n in names}
        for n in names:
            setattr(fa, n, lambda *a: route)
        try:
            yield
        finally:
            for n, fn in real.items():
                setattr(fa, n, fn)
    return ctx()


def _profiled_ms(fn, names, iters: int = 5, optional=()) -> dict:
    """Device ms per call of each named kernel inside ``fn`` (CUPTI, through
    torch.profiler), for kernels that one wrapper launches together; a
    name in ``optional`` that did not run reads 0."""
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
    for name in (*names, *optional):
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name)
        if us <= 0 and name not in optional:
            fail(f"the profiler saw no device time for {name}")
        out[name] = us / 1e3 / iters
    return out


def map_build_host_us(case) -> float:
    """Host microseconds a call of building one pass's four TMA tensor maps
    (q, dO, k, v) at ``case``'s shape, which the wgmma kernels' wrapper
    pays at every launch (the library's own clock, no Python in the
    loop)."""
    import ctypes

    import torch
    from repro_torch.kernels import build
    B, S, Hq, n_kv, D = case[:5]
    gen = torch.Generator(device="cuda").manual_seed(16)
    _, (q5, k4, v4) = make_qkv(case, torch.bfloat16, gen)
    rows = torch.zeros((B, n_kv, Hq // n_kv, S), device="cuda")
    fn = build.load("flash_bwd").flash_bwd_map_us
    fn.restype = ctypes.c_double
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int]
    dims = (ctypes.c_int64 * 6)(B, n_kv, Hq // n_kv, S, case_sk(case), D)
    # q, k, v, dO strides (dO laid out as q); the outputs' are not read
    strides = (ctypes.c_int64 * 24)(*q5.stride()[:4], *k4.stride()[:3],
                                    *v4.stride()[:3], *q5.stride()[:4])
    us = fn(q5.data_ptr(), k4.data_ptr(), v4.data_ptr(), q5.data_ptr(),
            rows.data_ptr(), rows.data_ptr(), dims, strides, MAP_BUILD_REPS)
    if us < 0:
        fail(f"the tensor maps could not be built at {case}")
    return us


def phase_train_kernel_times() -> dict:
    """The training slice's new kernels at its shapes: the backward pair at
    B=2, 32 heads, S=4096, D=128, causal, bf16, and quantize / dequantize
    over the 11 gradient leaves one step compresses (bf16 in, bf16 out),
    each beside its bound, its plain twin and the nearest PyTorch call."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import quantize as qz
    at = attn_times(TRAIN_CASE, iters=5, plain_iters=2, bwd=True)
    map_us = map_build_host_us(TRAIN_CASE)
    gen = torch.Generator(device="cuda").manual_seed(15)

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
    return {"flash_fwd_train_shape_ms": at["ms"],
            "flash_fwd_train_shape_mma_ms": at["mma_ms"],
            "flash_fwd_train_shape_device_ms": at["device_ms"],
            "flash_fwd_train_shape_mma_device_ms": at["mma_device_ms"],
            "flash_fwd_train_shape_route": at["fwd_route"],
            "flash_fwd_train_shape_tflops_per_s": at["tflops_per_s"],
            "flash_fwd_train_shape_bound_ms": at["bound_ms"],
            "flash_fwd_train_shape_bound_by": at["bound_by"],
            "flash_fwd_train_shape_plain_ms": at["plain_ms"],
            "sdpa_fwd_train_shape_ms": at["library_ms"],
            "flash_bwd_pair_ms": at["pair_ms"],
            "flash_bwd_pair_bound_ms": at["pair_bound_ms"],
            "flash_bwd_dq": {"ms": at["dq_ms"],
                             "bound_ms": at["dq_bound_ms"],
                             "bound_by": at["dq_bound_by"],
                             "mma_ms": at["mma_dq_ms"]},
            "flash_bwd_dkv": {"ms": at["dkv_ms"],
                              "bound_ms": at["dkv_bound_ms"],
                              "bound_by": at["dkv_bound_by"],
                              "mma_ms": at["mma_dkv_ms"]},
            "flash_bwd_route": at["route"],
            "flash_bwd_mma_pair_ms": at["mma_pair_ms"],
            "flash_bwd_map_build_host_us": map_us,
            "flash_bwd_plain_pair_ms": at["plain_pair_ms"],
            "sdpa_backward_ms": at["library_pair_ms"],
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
    decode_run = phase_decode_attention()
    decode_run.update(phase_decode_attention_scale())
    torch.cuda.empty_cache()
    slice_run = phase_slice()
    print(json.dumps({"slice": slice_run, "card": card}))
    offload_run = phase_serve_offload()
    print(json.dumps({"serve_offload": offload_run, "card": card}))
    train_run = phase_train()
    print(json.dumps({"train": train_run, "card": card}))
    torch.cuda.empty_cache()
    moe_serve_run = phase_moe_serve()
    print(json.dumps({"moe_serve": moe_serve_run, "card": card}))
    moe_train_run = phase_moe_train()
    print(json.dumps({"moe_train": moe_train_run, "card": card}))
    ssm_serve_run = phase_ssm_serve()
    print(json.dumps({"ssm_serve": ssm_serve_run, "card": card}))
    ssm_train_run = phase_ssm_train()
    print(json.dumps({"ssm_train": ssm_train_run, "card": card}))
    hybrid_serve_run = phase_hybrid_serve()
    print(json.dumps({"hybrid_serve": hybrid_serve_run, "card": card}))
    hybrid_train_run = phase_hybrid_train()
    print(json.dumps({"hybrid_train": hybrid_train_run, "card": card}))
    encdec_serve_run = phase_encdec_serve()
    print(json.dumps({"encdec_serve": encdec_serve_run, "card": card}))
    encdec_train_run = phase_encdec_train()
    print(json.dumps({"encdec_train": encdec_train_run, "card": card}))
    vlm_serve_run = phase_vlm_serve()
    print(json.dumps({"vlm_serve": vlm_serve_run, "card": card}))
    vlm_train_run = phase_vlm_train()
    print(json.dumps({"vlm_train": vlm_train_run, "card": card}))
    torch.cuda.empty_cache()
    dryrun_run = phase_dryrun({
        "train": train_run, "moe_train": moe_train_run,
        "ssm_train": ssm_train_run, "hybrid_train": hybrid_train_run,
        "encdec_train": encdec_train_run, "vlm_train": vlm_train_run})
    print(json.dumps({"dryrun": {
        name: {k: r[k] for k in ("predicted_peak_gb", "card_peak_gb",
                                 "peak_rel_err", "own_err_gb",
                                 "flops_ratio", "count_wall_s")}
        for name, r in dryrun_run.items()}, "card": card}))
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
    mt = phase_moe_kernel_times()
    print(json.dumps({"moe_kernel_times": mt, "card": card}))
    ht = phase_hybrid_kernel_times()
    print(json.dumps({"hybrid_kernel_times": ht, "card": card}))
    et = phase_encdec_kernel_times()
    print(json.dumps({"encdec_kernel_times": et, "card": card}))
    vt = phase_vlm_kernel_times()
    print(json.dumps({"vlm_kernel_times": vt, "card": card}))
    for name, r in phase_decode_attention_times().items():
        decode_run[name].update(r)
    decode_run.update(phase_decode_attention_scale(device_times=True))
    print(json.dumps({"ckpt_train": {
        k: v for k, v in ckpt_run.items()
        if k in ("result", "run_s", "check_s", "launches", "timings",
                 "peak_mem_gb", "host_after")}, "card": card}))
    train_runs = (train_run, moe_train_run, ssm_train_run, hybrid_train_run,
                  encdec_train_run, vlm_train_run)
    tl = {k: sum(r["launches"][k] for r in train_runs)
          for k in train_run["launches"]}
    # the backward passes of the training runs by route (all wgmma)
    routes = {k: sum(r["bwd_routes"][k] for r in train_runs)
              for k in ROUTES}
    # the forward launches of the serving and training runs by route (all
    # wgmma)
    serve_routes = [part for run in (slice_run, moe_serve_run,
                                     hybrid_serve_run, encdec_serve_run,
                                     vlm_serve_run)
                    for part in run["routes"].values()]
    fwd_routes = {k: sum(r["fwd_routes"][k] for r in train_runs)
                  + sum(part["fwd"][k] for part in serve_routes)
                  for k in ROUTES}
    bwd_extra = {"route_launches": routes,
                 "map_build_host_us": tt["flash_bwd_map_build_host_us"],
                 "mma_route_pair_ms": tt["flash_bwd_mma_pair_ms"]}
    # the shapes of the MoE, hybrid, encoder-decoder and VLM slices, beside
    # the bound and SDPA
    g16 = lambda key: {f"{key}_{fam}_{shape}": t[shape][key]
                       for fam, t in (("moe", mt), ("hybrid", ht),
                                      ("encdec", et), ("vlm", vt))
                       for shape in t if key in t[shape]}
    bwd_plain = tt["flash_bwd_plain_pair_ms"]  # the twin computes the pair
    sdpa_bwd = tt["sdpa_backward_ms"]          # likewise
    qt, dt = tt["quantize_per_step"], tt["dequantize_per_step"]
    csrc = "src/repro_torch/kernels/csrc/"
    record = {"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": csrc + "flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": slice_run["flash_fwd_launches"] + tl["flash_fwd"]
        + sum(n["flash_fwd"] for run in (offload_run, moe_serve_run,
                                         hybrid_serve_run, encdec_serve_run,
                                         vlm_serve_run)
              for n in run["launches"].values())
        + dryrun_run["prefill"]["launches"]["flash_fwd"],
        "max_abs_err": max(slice_err, fwd_train_err), "ms": times["ms"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"],
        "tflops_per_s": times["tflops_per_s"],
        "route_launches": fwd_routes, "mma_route_ms": times["mma_ms"],
        "device_ms": times["device_ms"],
        "mma_route_device_ms": times["mma_device_ms"],
        "device_ms_train_shape": tt["flash_fwd_train_shape_device_ms"],
        "mma_route_device_ms_train_shape":
            tt["flash_fwd_train_shape_mma_device_ms"],
        "ms_train_shape": tt["flash_fwd_train_shape_ms"],
        "mma_route_ms_train_shape": tt["flash_fwd_train_shape_mma_ms"],
        "tflops_per_s_train_shape": tt["flash_fwd_train_shape_tflops_per_s"],
        "bound_ms_train_shape": tt["flash_fwd_train_shape_bound_ms"],
        "library_ms_train_shape": tt["sdpa_fwd_train_shape_ms"],
        **g16("ms"), **g16("bound_ms"), **g16("plain_ms"),
        **g16("library_ms"), **g16("tflops_per_s"), **g16("mma_ms"),
        **g16("device_ms"), **g16("mma_device_ms"), **g16("fwd_route")}, {
        "name": "flash_bwd_dq", "route": "cuda", "source": csrc + "flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:222",
        "launches": tl["flash_bwd_dq"], "max_abs_err": bwd_err,
        "ms": tt["flash_bwd_dq"]["ms"], "plain_ms": bwd_plain,
        "bound_ms": tt["flash_bwd_dq"]["bound_ms"],
        "bound_by": tt["flash_bwd_dq"]["bound_by"], "library_ms": sdpa_bwd,
        "mma_route_ms": tt["flash_bwd_dq"]["mma_ms"], **bwd_extra,
        **g16("dq_ms"), **g16("dq_bound_ms"), **g16("pair_ms"),
        **g16("mma_dq_ms"), **g16("mma_pair_ms"), **g16("route"),
        **g16("plain_pair_ms"), **g16("library_pair_ms")}, {
        "name": "flash_bwd_dkv", "route": "cuda",
        "source": csrc + "flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:243",
        "launches": tl["flash_bwd_dkv"], "max_abs_err": bwd_err,
        "ms": tt["flash_bwd_dkv"]["ms"], "plain_ms": bwd_plain,
        "bound_ms": tt["flash_bwd_dkv"]["bound_ms"],
        "bound_by": tt["flash_bwd_dkv"]["bound_by"], "library_ms": sdpa_bwd,
        "mma_route_ms": tt["flash_bwd_dkv"]["mma_ms"], **bwd_extra,
        **g16("dkv_ms"), **g16("dkv_bound_ms"), **g16("pair_ms"),
        **g16("mma_dkv_ms"), **g16("dkv_chunks"), **g16("dkv_reduce_ms"),
        **g16("plain_pair_ms"), **g16("library_pair_ms")}, {
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
            ("shard_unpack", "src/repro/kernels/shard_pack.py:47"))] + [{
        "name": "decode_attn", "route": "cuda",
        "source": csrc + "decode_attn.cu", "replaces": None,
        "launches": sum(run["launches"]["decode"]["decode_attn"]
                        for run in (slice_run, moe_serve_run,
                                    hybrid_serve_run, encdec_serve_run,
                                    vlm_serve_run)),
        "max_abs_err": decode_run["max_abs_err"],
        "ms": decode_run["chat_last"]["ms"],
        "plain_ms": decode_run["chat_last"]["plain_ms"],
        "bound_ms": decode_run["chat_last"]["bound_ms"], "bound_by": "bytes",
        "library_ms": decode_run["chat_last"]["library_ms"], **{
            f"{key}_{name}": r[key]
            for name, r in decode_run.items() if isinstance(r, dict)
            for key in ("ms", "device_ms", "launches", "simt_device_ms",
                        "plain_ms", "bound_ms", "splits", "library_ms",
                        "library_device_ms", "library_launches",
                        "library_max_abs_err", "library_attention")
            if key in r}}]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

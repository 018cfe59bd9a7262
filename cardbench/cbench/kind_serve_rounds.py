"""The ``serve_rounds`` traffic kind: a closed loop of serving rounds through
the program's ``make_prefill_step`` and ``make_decode_step``, for any
configuration whose inputs are tokens alone (every decoder-only family of
the port).

Each round admits ``batch`` requests, prefills their prompts as one batch
into a cache of ``pad_to`` slots, takes the greedy first token from the
prefill's logits and decodes ``new_tokens - 1`` more, every token copied to
the host as it is made (that is when a user would see it).  Set-up warms
one round's shapes: a prefill and two decode steps.  The window admits
rounds until ``seconds`` have passed and closes when the last one is done.

Correctness: a sample of the finished requests, drawn from the seed, goes
through the plain reference once the program's state is freed: its fp32
logits over each prompt and the served tokens, and at each served token
the gap by which that token's logit lies below the reference's best.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import counts, hostwatch, plain, program, trace, traffic, weights


def greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def serve_round(prefill, decode, params, prompts, n_new: int, clock):
    """One round -> (tokens (B, n_new) on the host, the host times at which
    each token arrived, the admission time)."""
    t_admit = clock()
    logits, cache = prefill(params, {"tokens": prompts})
    tok = greedy(logits)
    out, times = [tok.cpu()], [clock()]
    S = prompts.shape[1]
    for j in range(n_new - 1):
        tok, _, cache = decode(params, cache, tok, S + j)
        out.append(tok.cpu())
        times.append(clock())
    del cache
    return torch.cat(out, dim=1), times, t_admit


REF_GROUP = 6       # sequences the reference takes at once


def reference_gaps(ctx, sample, ref_prec: str | None = None) -> float:
    """The widest gap, over every served token of ``sample`` ([(prompt,
    tokens)] on the host), by which the token's logit lies below the best
    logit of the fp32 reference.  With ``ref_prec`` the tokens judged are
    instead the ones a reference in that precision puts first (the
    control)."""
    plain.exact()
    dev = ctx.device
    params = weights.make_flat(ctx.seed, ctx.layout, dev)
    ref = ctx.refmod.Model(ctx.spec, "fp32")
    low = ctx.refmod.Model(ctx.spec, ref_prec) if ref_prec else None
    widest = 0.0
    for g in range(0, len(sample), REF_GROUP):
        part = sample[g:g + REF_GROUP]
        P = part[0][0].shape[0]
        seq = torch.stack([torch.cat([p, t[:-1]]) for p, t in part]).to(dev)
        served = torch.stack([t for _, t in part]).to(dev).long()
        rows = slice(P - 1, seq.shape[1])
        logits = ref.logits(params, seq, rows)
        if low is not None:
            served = low.logits(params, seq, rows).argmax(dim=-1)
        got = torch.gather(logits, -1, served[..., None])[..., 0]
        widest = max(widest, float((logits.amax(dim=-1) - got).max()))
        del logits
    del params
    ctx.free()
    return widest


def pick_sample(ctx, finished) -> list:
    """``sample_requests`` of the finished requests, drawn from the seed."""
    gen = weights.generator("cpu", ctx.seed, "sample")
    order = torch.randperm(len(finished), generator=gen).tolist()
    return [finished[i] for i in order[:ctx.mix["sample_requests"]]]


def program_state(ctx):
    """The program's params and serving steps, one round's shapes warmed
    (a prefill and two decode steps)."""
    from repro_torch.serve import make_decode_step, make_prefill_step
    mix = ctx.mix
    inputs = ctx.refmod.input_shapes(ctx.spec, mix["batch"],
                                     mix["prompt_len"])
    if set(inputs) != {"tokens"}:
        raise ValueError(f"serve_rounds feeds prompts of tokens alone; "
                         f"{ctx.work['config']} also takes "
                         f"{sorted(set(inputs) - {'tokens'})}")
    ctx.gen = traffic.Generator(mix, ctx.seed, ctx.spec["vocab"], ctx.device)
    params = weights.make_params(ctx.seed, ctx.layout, ctx.device)
    ctx.mark("weights")
    prefill = make_prefill_step(ctx.mc, pad_to=mix["pad_to"],
                                device=ctx.device)
    decode = make_decode_step(ctx.mc, device=ctx.device)
    if ctx.step_wrap is not None:
        prefill, decode = ctx.step_wrap(prefill, decode)
    serve_round(prefill, decode, params,
                ctx.gen.tokens(mix["batch"], mix["prompt_len"], "warm"), 3,
                time.perf_counter)
    return params, prefill, decode


def rounds(ctx, params, prefill, decode, seconds=None, count=None) -> dict:
    """Rounds back to back until ``seconds`` have passed (the last one
    finished) or ``count`` rounds are done."""
    mix = ctx.mix
    Bq, P, N = mix["batch"], mix["prompt_len"], mix["new_tokens"]
    finished, ttft, tpot, prefill_s = [], [], [], 0.0
    watch, marks = hostwatch.Watch(), []
    watch.start()
    t0 = time.perf_counter()
    r, end = 0, t0
    while (time.perf_counter() - t0 < seconds) if count is None \
            else r < count:
        prompts = ctx.gen.tokens(Bq, P, "round", r)
        toks, times, t_admit = serve_round(prefill, decode, params, prompts,
                                           N, time.perf_counter)
        ttft += [times[0] - t_admit] * Bq
        tpot += [b - a for a, b in zip(times, times[1:])] * Bq
        prefill_s += times[0] - t_admit
        host = prompts.cpu()
        finished += [(host[i], toks[i]) for i in range(Bq)]
        end = times[-1]
        marks.append(end)
        r += 1
    return {"finished": finished, "ttft": ttft, "tpot": tpot,
            "prefill_s": prefill_s, "rounds": r, "seconds": end - t0,
            "host": watch.stop(marks)}


def run(ctx) -> dict:
    mix = ctx.mix
    Bq, P, N = mix["batch"], mix["prompt_len"], mix["new_tokens"]
    params, prefill, decode = program_state(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    w = rounds(ctx, params, prefill, decode, seconds=ctx.seconds)
    peak = ctx.memory_peak()
    e2e = {"serve_tokens_per_s": len(w["finished"]) * N / w["seconds"],
           "tpot_p95_ms": float(np.percentile(w["tpot"], 95)) * 1e3,
           "ttft_p95_ms": float(np.percentile(w["ttft"], 95)) * 1e3,
           "setup_s": setup_s}
    rec = {"kind": "serve", "spec": ctx.spec, "mix": mix,
           "layout": ctx.layout,
           "attention_calls": ctx.refmod.attention_calls(ctx.spec, Bq, P),
           "window": {"rounds": w["rounds"], "seconds": w["seconds"],
                      "prefill_seconds": w["prefill_s"],
                      "prefill_flops": counts.model_flops(
                          ctx.refmod, "prefill_flops", ctx.layout, ctx.spec,
                          Bq, P)}}

    if ctx.trace:
        def traced():
            from torch.profiler import record_function
            program.zero_counters()
            prompts = ctx.gen.tokens(Bq, P, "traced")
            n = mix["trace_decode_steps"]
            with record_function("cardbench.prefill"):
                logits, cache = prefill(params, {"tokens": prompts})
                tok = greedy(logits)
                tok.cpu()
            for j in range(n):
                with record_function("cardbench.decode"):
                    tok, _, cache = decode(params, cache, tok, P + j)
                    tok.cpu()
            return {"prefills": 1, "decode_steps": n}
        rec["trace"] = trace.run_traced(traced)
        rec["trace"]["counters"] = program.counters()
    ctx.check_modules()
    del params, prefill, decode
    ctx.free()

    t_ref = time.perf_counter()
    sample = pick_sample(ctx, w["finished"])
    numbers = {"token_gap": reference_gaps(ctx, sample),
               "sampled_tokens": len(sample) * N,
               "reference_s": time.perf_counter() - t_ref,
               "host": w["host"]}
    return {"e2e": e2e, "record": rec, "memory_peak_bytes": peak,
            "attempted": len(w["finished"]), "failed": 0, "numbers": numbers}

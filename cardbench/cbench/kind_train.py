"""The ``train`` traffic kind: a closed loop of the program's training steps.

Set-up builds one training step with its params and optimizer state, drives
it through the mix's ``ref_steps`` first steps (the warm-up, on rows that
all differ) and records what the comparison needs: each step's loss, the
first gradient as the optimizer got it, worked out from its state after one
step, and the change of every param over those steps.  The window then
runs step after step on the same objects for ``seconds``.  After it the
program's state is freed and the plain reference follows the same first
steps from the same weights and rows.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from . import counts, hostwatch, plain, program, trace, traffic, weights

B1 = 0.9        # AdamW's first-moment decay, the program's default


def program_grad_norms(state: dict, layout, optimizer: str,
                       stack_keys=weights.STACKS) -> dict:
    """By part, the norm of the gradient the optimizer took at step 1, from
    its state: AdamW's m = (1 - b1) g; Adafactor's second moments, whose
    factored row means (or unfactored squares) times (1 - beta2) add up
    to the squared gradient."""
    out = {}
    # 1 - beta2 at step 1, in fp32 as the program computes it
    one_minus = float(1.0 - (1.0 - (torch.tensor(2.0) ** -0.8)))
    for path, shape, *_ in layout:
        parts = weights.slices(path, shape, stack_keys)
        if optimizer == "adamw":
            m = weights.get(state["m"], path)
            for name, i in parts:
                out[name] = float(torch.linalg.vector_norm(m[i])) / (1 - B1)
            continue
        vr = weights.get(state["vr"], path)
        fac = len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1
        cols = shape[-1] if fac else 1
        for name, i in parts:
            out[name] = math.sqrt(float(vr[i].double().sum()) * cols
                                  / one_minus)
    return out


def change_norms(params, seed: int, layout, device,
                 stack_keys=weights.STACKS) -> dict:
    """By part, the norm of each param's change since the weights were
    made (made again from the seed, one leaf at a time)."""
    out = {}
    for index, item in enumerate(layout):
        path, shape, init, dtype = weights.entry(item)
        p0 = weights.make_leaf(seed, index, shape, init, device, dtype)
        p = params[path] if isinstance(params, dict) and path in params \
            else weights.get(params, path)
        for name, i in weights.slices(path, shape, stack_keys):
            out[name] = float(torch.linalg.vector_norm(
                p[i].float() - p0[i].float()))
        del p0
    return out


def gap(got: float, want: float, scale: float) -> float:
    return abs(got - want) / max(abs(want), scale, 1e-30)


def compare(prog: dict, ref: dict) -> dict:
    """The widest relative gap of a step's loss and the first step's; by the
    worst part, the gap between the program's and the reference's norm of
    the first gradient and of the change, each against the larger of the
    reference's norm of that part and of the median part.  Parts whose
    reference gradient is under a thousandth of the median part's move by
    round-off alone and are left out of the change."""
    loss = max(gap(a, b, 0.0) for a, b in zip(prog["losses"], ref["losses"]))
    first = gap(prog["losses"][0], ref["losses"][0], 0.0)
    g_med = statistics.median(ref["grad_norms"].values())
    grad = max(gap(prog["grad_norms"][k], v, g_med)
               for k, v in ref["grad_norms"].items())
    keep = [k for k, v in ref["grad_norms"].items() if v >= 1e-3 * g_med]
    c_med = statistics.median(ref["change_norms"][k] for k in keep)
    worst = max(keep, key=lambda k: gap(prog["change_norms"][k],
                                         ref["change_norms"][k], c_med))
    change = gap(prog["change_norms"][worst], ref["change_norms"][worst],
                 c_med)
    return {"loss_gap": loss, "first_loss_gap": first, "grad_gap": grad,
            "change_gap": change, "worst_change_part": worst,
            "worst_grad_part": max(ref["grad_norms"], key=lambda k: gap(
                prog["grad_norms"][k], ref["grad_norms"][k], g_med)),
            "parts_left_out": len(ref["grad_norms"]) - len(keep)}


def summary(prog: dict, ref: dict, n: int = 5) -> dict:
    """Both sides' losses and, for the parts that differ most, both
    norms of the first gradient and of the change."""
    out = {"losses": {"program": prog["losses"], "reference": ref["losses"]}}
    for key in ("grad_norms", "change_norms"):
        worst = sorted(ref[key], key=lambda k: -abs(prog[key][k] - ref[key][k])
                       / max(abs(ref[key][k]), 1e-30))[:n]
        out[key] = {k: [prog[key][k], ref[key][k]] for k in worst}
    return out


def reference_readings(ctx) -> dict:
    """The fp32 reference's losses, first-gradient norms and change norms
    over the mix's first steps, from the seed's weights and rows."""
    plain.exact()
    dev = ctx.device
    params = weights.make_flat(ctx.seed, ctx.layout, dev)
    model = ctx.refmod.Model(ctx.spec, "fp32")
    stack_keys = weights.stacks(ctx.spec)
    r = plain.train_reference(model, params, ctx.layout, ctx.batches,
                              ctx.mix["ref_steps"], ctx.spec["optimizer"],
                              ctx.spec["grad_compression"], stack_keys)
    r["change_norms"] = change_norms(params, ctx.seed, ctx.layout, dev,
                                     stack_keys)
    del params
    ctx.free()
    return r


def program_setup(ctx, step_wrap=None):
    """The program's training step, params and state after the mix's first
    steps, and the readings of those steps."""
    from repro_torch.train import make_train_step, opt_init
    params = weights.make_params(ctx.seed, ctx.layout, ctx.device)
    state = opt_init(ctx.mc.optimizer, params)
    step = make_train_step(ctx.mc, device=ctx.device)
    ctx.mark("weights")
    if step_wrap is not None:
        step = step_wrap(step)
    stack_keys = weights.stacks(ctx.spec)
    losses, grad_norms = [], None
    for k in range(ctx.mix["ref_steps"]):
        params, state, m = step(params, state, ctx.batches(k))
        losses.append(float(m["loss"]))
        if k == 0:
            grad_norms = program_grad_norms(state, ctx.layout,
                                            ctx.spec["optimizer"],
                                            stack_keys)
            ctx.mark("first_step")
    ctx.mark("steps")
    readings = {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change_norms(params, ctx.seed, ctx.layout,
                                             ctx.device, stack_keys)}
    return step, params, state, readings


def prepare(ctx) -> None:
    """``ctx.batches(k)``: step k's rows, drawn from the seed."""
    B, S = ctx.mix["batch"], ctx.mix["positions"]
    shapes = ctx.refmod.input_shapes(ctx.spec, B, S)
    gen = traffic.Generator(ctx.mix, ctx.seed, ctx.spec["vocab"], ctx.device)
    ctx.batches = lambda k: gen.batch(shapes, "step", k)


def run(ctx) -> dict:
    mix = ctx.mix
    B, S = mix["batch"], mix["positions"]
    prepare(ctx)
    step, params, state, prog = program_setup(ctx, ctx.step_wrap)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    k = mix["ref_steps"]
    watch, marks = hostwatch.Watch(), []
    watch.start()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < ctx.seconds:
        params, state, _ = step(params, state, ctx.batches(k))
        k += 1
        steps += 1
        marks.append(time.perf_counter())
    ctx.sync()
    window_s = time.perf_counter() - t0
    host = watch.stop(marks)
    peak = ctx.memory_peak()
    flops = counts.model_flops(ctx.refmod, "train_model_flops", ctx.layout,
                               ctx.spec, B, S)
    rec = {"kind": "train", "spec": ctx.spec, "mix": mix,
           "layout": ctx.layout, "attention_calls":
           ctx.refmod.attention_calls(ctx.spec, B, S),
           "window": {"steps": steps, "seconds": window_s,
                      "step_flops": flops}}
    e2e = {"train_tokens_per_s": steps * B * S / window_s,
           "setup_s": setup_s}

    if ctx.trace:
        def traced():
            nonlocal params, state
            from torch.profiler import record_function
            program.zero_counters()
            for t in range(mix["trace_steps"]):
                with record_function("cardbench.train_step"):
                    params, state, _ = step(params, state,
                                            ctx.batches(k + t))
            return {"steps": mix["trace_steps"]}
        rec["trace"] = trace.run_traced(traced)
        rec["trace"]["counters"] = program.counters()
    ctx.check_modules()
    del step, params, state
    ctx.free()

    t_ref = time.perf_counter()
    ref = reference_readings(ctx)
    numbers = compare(prog, ref)
    numbers["reference_s"] = time.perf_counter() - t_ref
    numbers["host"] = host
    return {"e2e": e2e, "record": rec, "memory_peak_bytes": peak,
            "attempted": steps, "failed": 0, "numbers": numbers,
            "readings": summary(prog, ref)}

"""Readings that the limits of ``correct`` are set from: the program's
sound runs over many seeds, the control (the reference in fp8 put in the
program's place) and, for training, a planted fault (half of each batch
left out, the mean taken over the rest), each against the fp32 reference
at the cell's own size.  Not run by the benchmark's own runs.

``train_control`` and ``serve_control`` are ``step_wrap`` hooks: they put
the reference in a lower precision where the program's steps were, so that
a whole run of the harness (``Cell.run``) judges it as it judges the
program.
"""
from __future__ import annotations

import math

import torch

from . import kind_serve_rounds, kind_train, plain, weights


def _flat(cell, params) -> dict:
    return {p: weights.get(params, p) for p, *_ in cell.layout}


def train_control(cell, prec: str = "fp8"):
    """A training step that is the plain reference in ``prec``: forward,
    backward, clip, int8 and the optimizer, on the params it is handed
    (updated in place), its optimizer state returned in the program's
    form, which the readings take the first gradient from."""
    model = cell.refmod.Model(cell.spec, prec)
    opt, comp = cell.spec["optimizer"], cell.spec["grad_compression"]

    def wrap(_program_step):
        st = None

        def step(params, _state, batch):
            nonlocal st
            plain.exact()
            flat = _flat(cell, params)
            if st is None:
                st = plain.opt_init(opt, flat)
            loss, grads = model.loss_and_grads(flat, batch)
            plain.clip_(grads)
            if comp:
                plain.compress_(grads)
            plain.opt_update_(opt, grads, st, flat)
            state = {k: weights.nested(v) for k, v in st.items()
                     if isinstance(v, dict)}
            return params, state, {"loss": loss}
        return step
    return wrap


def serve_control(cell, prec: str = "fp8"):
    """Serving steps that are the plain reference in ``prec``: the cache is
    the sequence so far, and each step takes the token that the reference
    puts first at its last position."""
    model = cell.refmod.Model(cell.spec, prec)

    def last_logits(params, seq):
        plain.exact()
        T = seq.shape[1]
        return model.logits(_flat(cell, params), seq, slice(T - 1, T))

    def wrap(_prefill, _decode):
        def prefill(params, batch):
            seq = batch["tokens"]
            return last_logits(params, seq), seq

        def decode(params, seq, tok, _pos):
            seq = torch.cat([seq, tok.to(seq.dtype)], dim=1)
            logits = last_logits(params, seq)
            return kind_serve_rounds.greedy(logits), logits, seq
        return prefill, decode
    return wrap


def _half(step):
    def halved(params, state, batch):
        return step(params, state, {k: v[:v.shape[0] // 2]
                                    for k, v in batch.items()})
    return halved


def train_seed(cell, seed: int, control=False, half=False) -> dict:
    cell.seed = seed
    kind_train.prepare(cell)
    out = {"seed": seed}
    _, params, state, prog = kind_train.program_setup(cell)
    del params, state
    cell.free()
    ref = kind_train.reference_readings(cell)
    out["program"] = kind_train.compare(prog, ref)
    out["program"]["losses"] = prog["losses"]
    out["reference_losses"] = ref["losses"]
    if half:
        _, params, state, bad = kind_train.program_setup(cell, _half)
        del params, state
        cell.free()
        out["half_batch"] = kind_train.compare(bad, ref)
    if control:
        _, params, state, ctl = kind_train.program_setup(
            cell, train_control(cell))
        del params, state
        cell.free()
        out["control"] = kind_train.compare(ctl, ref)
    return out


def serve_seed(cell, seed: int, control=False) -> dict:
    cell.seed = seed
    params, prefill, decode = kind_serve_rounds.program_state(cell)
    n = math.ceil(cell.mix["sample_requests"] / cell.mix["batch"])
    w = kind_serve_rounds.rounds(cell, params, prefill, decode, count=n)
    del params, prefill, decode
    cell.free()
    sample = kind_serve_rounds.pick_sample(cell, w["finished"])
    out = {"seed": seed, "program": {
        "token_gap": kind_serve_rounds.reference_gaps(cell, sample)}}
    if control:
        out["control"] = {"token_gap": kind_serve_rounds.reference_gaps(
            cell, sample, ref_prec="fp8")}
    return out

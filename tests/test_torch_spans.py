"""The port's spans (``repro_torch.spans``): off with no profiler running
(no ``record_function`` entered, nothing recorded), on under one with the
counts the code implies, nested in the caller's profiler ranges, and
without effect on what a step computes.  CPU, the smoke deepseek-7b and
seamless-m4t-large-v2 configs."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.configs import ARCHS, ShapeConfig, smoke_variant
from repro_torch.models import init_model, make_inputs
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.train import make_train_step, opt_init
from repro_torch.tree import tree_items, tree_map

ARCH_IDS = ["deepseek-7b", "seamless-m4t-large-v2"]
PHASES = ["train.forward", "train.backward", "train.clip", "train.compress",
          "train.optimizer"]
S, B, PAD, DECODE_STEPS = 16, 2, 24, 3


def _cfg(arch, compression=True):
    return dataclasses.replace(smoke_variant(ARCHS[arch]),
                               grad_compression=compression,
                               optimizer="adamw")


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _world(arch, compression=True):
    cfg = _cfg(arch, compression)
    gen = torch.Generator().manual_seed(3)
    params = init_model(gen, cfg, device="cpu")
    train = [make_inputs(gen, cfg, ShapeConfig("t", S, B, "train"),
                         device="cpu") for _ in range(2)]
    prompt = make_inputs(gen, cfg, ShapeConfig("p", S, B, "prefill"),
                         device="cpu")
    return cfg, params, train, prompt


def _decoder_layers(cfg):
    return cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers


def _train(cfg, params, batches):
    step = make_train_step(cfg, device="cpu")
    state = opt_init(cfg.optimizer, params)
    out = []
    for b in batches:
        params, state, m = step(params, state, b)
        out.append(m)
    return params, state, out


def _serve(cfg, params, prompt, steps=DECODE_STEPS):
    prefill = make_prefill_step(cfg, pad_to=PAD, device="cpu")
    decode = make_decode_step(cfg, device="cpu")
    logits, cache = prefill(params, prompt)
    out = [logits]
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    pos = prompt["tokens"].shape[1]
    for j in range(steps):
        tok, logits, cache = decode(params, cache, tok, pos + j)
        out.append(logits)
    return out


def _profiled(fn):
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.outer"):
            got = fn()
    return got, spans.record(), prof


@pytest.fixture(autouse=True)
def _empty_record():
    spans.reset()
    yield
    spans.reset()


# --------------------------------- off ---------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_off_records_nothing_and_enters_no_range(arch, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cfg, params, train, prompt = _world(arch)
    assert not torch.autograd._profiler_enabled()
    _train(cfg, params, train[:1])
    _serve(cfg, params, prompt, steps=1)
    assert spans.record() == {}


def test_off_span_is_one_shared_object():
    assert spans.span("a") is spans.span("b")
    with spans.span("a") as got:
        assert got is None
    assert spans.record() == {}


# ---------------------------------- on ----------------------------------

@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_training_spans_once_a_step(arch, compression):
    cfg, params, train, _ = _world(arch, compression)
    _, rec, _ = _profiled(lambda: _train(cfg, params, train))
    want = {"train.step"} | set(PHASES)
    if not compression:
        want.discard("train.compress")
    assert set(rec) == want
    assert all(r["count"] == len(train) for r in rec.values())
    step, phases = rec["train.step"], want - {"train.step"}
    for name in phases:
        assert 0 < rec[name]["host_s"] <= step["host_s"]
    for r in rec.values():
        assert 0 <= r["self_s"] <= r["host_s"]
    # the phases nest in the step: its self time is what they leave out
    inside = sum(rec[n]["host_s"] for n in phases)
    assert inside <= step["host_s"]
    assert step["self_s"] == pytest.approx(step["host_s"] - inside)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_spans_and_decode_attention_once_a_layer(arch):
    cfg, params, _, prompt = _world(arch)
    _, rec, _ = _profiled(lambda: _serve(cfg, params, prompt))
    assert set(rec) == {"serve.prefill", "serve.decode", "decode.attention"}
    assert rec["serve.prefill"]["count"] == 1
    assert rec["serve.decode"]["count"] == DECODE_STEPS
    assert rec["decode.attention"]["count"] \
        == _decoder_layers(cfg) * DECODE_STEPS
    assert 0 < rec["decode.attention"]["host_s"] \
        <= rec["serve.decode"]["host_s"]
    assert rec["serve.decode"]["self_s"] == pytest.approx(
        rec["serve.decode"]["host_s"] - rec["decode.attention"]["host_s"])
    for r in rec.values():
        assert 0 <= r["self_s"] <= r["host_s"]


def _chain(event):
    out, p = [], event.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ranges_nest_in_the_callers_range(arch):
    """Every ``repro_torch.`` range lies inside the test's own range on the
    profiler's tree, and each phase inside its step."""
    cfg, params, train, prompt = _world(arch)
    _, _, prof = _profiled(lambda: (_train(cfg, params, train[:1]),
                                    _serve(cfg, params, prompt, steps=1)))
    ours = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    names = {e.name[len(spans.PREFIX):] for e in ours}
    assert names == {"train.step", "serve.prefill", "serve.decode",
                     "decode.attention"} | set(PHASES)
    parents = {"train.step": None, "serve.prefill": None,
               "serve.decode": None, "decode.attention": "serve.decode",
               **{p: "train.step" for p in PHASES}}
    for e in ours:
        chain = _chain(e)
        assert "test.outer" in chain, e.name
        want = parents[e.name[len(spans.PREFIX):]]
        if want is not None:
            assert spans.PREFIX + want in chain, e.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_outputs_bit_identical_with_the_profiler_on_and_off(arch):
    cfg, params, train, prompt = _world(arch)
    off = _train(cfg, _clone(params), train), _serve(cfg, params, prompt)
    on, rec, _ = _profiled(lambda: (_train(cfg, _clone(params), train),
                                    _serve(cfg, params, prompt)))
    assert rec
    (p0, s0, m0), l0 = off
    (p1, s1, m1), l1 = on
    for (path, a), (_, b) in zip(tree_items(p0), tree_items(p1)):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(tree_items(s0), tree_items(s1)):
        assert torch.equal(a, b), path
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))


# ------------------------------ the record ------------------------------

def test_self_time_leaves_out_nested_spans_and_reset_empties():
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            for _ in range(3):
                with spans.span("inner"):
                    torch.ones(8).sum()
        with spans.span("outer"):
            pass
    rec = spans.record()
    assert rec["outer"]["count"] == 2 and rec["inner"]["count"] == 3
    assert rec["inner"]["self_s"] == rec["inner"]["host_s"]
    assert rec["outer"]["self_s"] == pytest.approx(
        rec["outer"]["host_s"] - rec["inner"]["host_s"])
    rec["outer"]["count"] = 99          # a copy: the record is unchanged
    assert spans.record()["outer"]["count"] == 2
    spans.reset()
    assert spans.record() == {}


def test_a_span_left_by_an_exception_is_recorded_and_the_error_kept():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with spans.span("outer"):
                with spans.span("fails"):
                    raise ValueError("x")
        with spans.span("after"):
            pass
    rec = spans.record()
    assert rec["fails"]["count"] == rec["outer"]["count"] == 1
    assert rec["after"]["self_s"] == rec["after"]["host_s"]


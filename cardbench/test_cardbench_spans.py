"""The readers of the program's span record (``cbench.program_spans`` and
the eight ``metrics/*_host_ms.*`` files): the ratio on a record built by
hand, None where a span or its divisor is missing, the mean over two
traced sub-windows, nothing from a program without spans, and the
readings over the program's own record of a smoke step (CPU, no card)."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cbench import harness, program_spans

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "cardbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

# metric -> (span, divisor span)
READERS = {
    "forward_host_ms.train": ("train.forward", "train.step"),
    "backward_host_ms.train": ("train.backward", "train.step"),
    "clip_host_ms.train": ("train.clip", "train.step"),
    "compress_host_ms.train": ("train.compress", "train.step"),
    "optimizer_host_ms.train": ("train.optimizer", "train.step"),
    "decode_host_ms.serve": ("serve.decode", "serve.decode"),
    "decode_attention_host_ms.serve": ("decode.attention", "serve.decode"),
    "prefill_host_ms.serve": ("serve.prefill", "serve.prefill"),
}
TRAIN = [m for m in READERS if m.endswith(".train")]


def reader(name):
    return harness.load_module(HERE / "metrics" / f"{name}.py",
                               "m_" + harness._ident(name))


def read(name, rec, monkeypatch):
    monkeypatch.setattr(program_spans, "record", lambda: rec)
    return reader(name).read({"kind": "any"})


def entry(count, host_s):
    return {"count": count, "host_s": host_s, "self_s": host_s / 2}


def test_the_readers_are_the_benchmarks_span_metrics():
    got = {m["name"]: m for m in BENCH["per_layer"]
           if m["source"] == "program_span"}
    assert set(got) == set(READERS)
    for name, m in got.items():
        assert m["unit"] == "ms" and m["better"] == "lower"
        cell = ("seamless-m4t-large-v2.train-2x4k" if name in TRAIN else
                "deepseek-7b.serve-rag" if name.startswith("prefill") else
                "deepseek-7b.serve-chat")
        assert m["workloads"] == [cell]


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_host_ms_per_divisor_entry(name, monkeypatch):
    span, per = READERS[name]
    rec = {per: entry(4, 2.0), "other": entry(1, 9.0)}
    rec.setdefault(span, entry(31 * 4, 0.5))
    want = 1e3 * rec[span]["host_s"] / 4
    assert read(name, rec, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_none_where_a_span_is_missing(name, monkeypatch):
    span, per = READERS[name]
    full = {span: entry(2, 0.5), per: entry(2, 1.0)}
    for missing in {span, per}:
        rec = {k: v for k, v in full.items() if k != missing}
        assert read(name, rec, monkeypatch) is None
    assert read(name, {}, monkeypatch) is None
    assert read(name, {span: entry(0, 0.0), per: entry(0, 0.0)},
                monkeypatch) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_the_mean_over_two_sub_windows(name, monkeypatch):
    """Two traced sub-windows in one process add to one record; the
    reading is the mean over both, not the first or the sum."""
    span, per = READERS[name]
    first = {per: entry(2, 0.20), span: entry(2, 0.08)}
    second = {per: entry(3, 0.45), span: entry(3, 0.21)}
    both = {k: {f: first[k][f] + second[k][f] for f in first[k]}
            for k in first}
    want = 1e3 * both[span]["host_s"] / both[per]["count"]
    assert read(name, both, monkeypatch) == pytest.approx(want)
    lone = 1e3 * first[span]["host_s"] / first[per]["count"]
    if span != per:
        assert want != pytest.approx(lone)


def test_a_program_without_spans_gives_nothing(monkeypatch):
    """A port from before its spans has no ``repro_torch.spans``: every
    reader returns None and none raises."""
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert program_spans.record() == {}
    for name in READERS:
        assert reader(name).read({"kind": "any"}) is None


def test_readers_over_the_programs_own_record_of_a_smoke_step():
    from repro_torch import spans
    from repro_torch.configs import ARCHS, ShapeConfig, smoke_variant
    from repro_torch.models import init_model, make_inputs
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.train import make_train_step, opt_init
    cfg = dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                              grad_compression=True, optimizer="adamw")
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, cfg, device="cpu")
    batch = make_inputs(gen, cfg, ShapeConfig("t", 16, 2, "train"),
                        device="cpu")
    prefill = make_prefill_step(cfg, pad_to=20, device="cpu")
    decode = make_decode_step(cfg, device="cpu")
    step = make_train_step(cfg, device="cpu")
    state = opt_init(cfg.optimizer, params)
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                params, state, _ = step(params, state, batch)
            logits, cache = prefill(params, {"tokens": batch["tokens"]})
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].int()
            for j in range(2):
                tok, _, cache = decode(params, cache, tok, 16 + j)
        got = {n: reader(n).read({"kind": "any"}) for n in READERS}
        step_ms = program_spans.host_ms("train.step", "train.step")
    finally:
        spans.reset()
    assert all(v is not None and v > 0 for v in got.values()), got
    assert sum(got[n] for n in TRAIN) <= step_ms
    assert got["decode_attention_host_ms.serve"] \
        <= got["decode_host_ms.serve"]

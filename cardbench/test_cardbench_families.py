"""The harness opened to every decoder-only family of the port (CPU, no
card): leaves in a dtype and from an initialiser of their own, made again
alone bit for bit, the two first configurations' leaves as they were; cuts
named in the configuration file and held to its ``reduced``; serving any
configuration that takes tokens alone; a configuration's own FLOP count;
device time and launches by program span; the decode-attention counter;
and the two readers of the chat cell that read them.  Whole ``Cell.run()``
calls of the port's MoE and Mamba2 decoders at smoke widths, from a root
of their own, come out correct."""
import dataclasses
import hashlib
import json
import time
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType

from cbench import counts, harness, program, readers, trace, weights

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "cardbench"
SEED = 2 ** 31 + 2718

# ------------------------------------------------- values of the parent tree
# recorded with the harness as it stood before leaves named their dtype and
# initialiser, spans their device time, and configurations their counts
TINY = {"deepseek-7b": {"hidden_size": 128, "intermediate_size": 256,
                        "num_hidden_layers": 4, "num_attention_heads": 4,
                        "num_key_value_heads": 4, "vocab_size": 512,
                        "run": {"padded_vocab_size": 512}},
        "seamless-m4t-large-v2": {"hidden_size": 128, "encoder_layers": 6,
                                  "decoder_layers": 6,
                                  "encoder_attention_heads": 4,
                                  "decoder_attention_heads": 4,
                                  "encoder_ffn_dim": 256,
                                  "decoder_ffn_dim": 256, "vocab_size": 512,
                                  "run": {"padded_vocab_size": 512}}}
# sha256 over every leaf's bits, in layout order, at the TINY sizes
LEAF_HASHES = {
    ("deepseek-7b", SEED, "bfloat16"):
        "4fc7bc8ccf5fe5d4268dac9ca7b2510a2ae60f790d1384c67155205f4b00e9e6",
    ("deepseek-7b", SEED, "float32"):
        "116f65dc13dfb8ac66dfd22aafb1f668c1cb937fcec729dbc333e888f53e309c",
    ("deepseek-7b", 7, "bfloat16"):
        "0acdf618f5afdb02662935592832b85ec570fd39e116c8436da0dba99c938ab1",
    ("deepseek-7b", 7, "float32"):
        "93c731e0173506cb65ffb4c246310c6b854d66f8e855df7f031b5f0b2cae00b7",
    ("seamless-m4t-large-v2", SEED, "bfloat16"):
        "b4f9bf544994ce4746fb5ad3d2ad3443ebe3483a9a4596ce934374f7e5d07880",
    ("seamless-m4t-large-v2", SEED, "float32"):
        "f7524d8fdb0df048087d7fd1467efebff4ab9050377c3f93caaaf4261fed4d62",
    ("seamless-m4t-large-v2", 7, "bfloat16"):
        "0f4115f1b182cf8207f2cad277caf116c619fc33ab2b9d0cad04794154851354",
    ("seamless-m4t-large-v2", 7, "float32"):
        "6bb7d3cff745dc7c02b0c036ee2d0b5cf8f0e699e66984b634c221842b81fedc"}
SUB_SEEDS = {(SEED, "weight", 3): 3080837380854040632,
             (123456789012, "tokens", "round", 5): 5181049500402244845}
# the three cells' model FLOPs at their shapes
FLOPS = {("deepseek-7b", "prefill_flops", 16, 1024): 203091689340928.0,
         ("deepseek-7b", "prefill_flops", 4, 2048): 103604073529344.0,
         ("seamless-m4t-large-v2", "train_model_flops", 2, 4096):
             39850182967296.0,
         ("deepseek-7b", "train_model_flops", 2, 4096): 343787503091712.0}
FLASH = ("void (anonymous namespace)::flash_fwd_wg_kernel<128, 128>("
         "(anonymous namespace)::WgParams)")
DATTN = ("void (anonymous namespace)::decode_attn_simt_kernel<__nv_bfloat16,"
         " 16, 1, 1>((anonymous namespace)::Params)")
ELEM = "void at::native::vectorized_elementwise_kernel<4>"
MEMCPY = "Memcpy DtoH (Device -> Pageable)"
# run_traced over the synthetic profile below
TRACE = {
    "busy_s": 9.2e-05, "launches": 6,
    "by_category_s": {"elementwise_other": 1.7e-05, "flash_fwd": 4e-05,
                      "gemm": 3.5000000000000004e-05},
    "by_name_s": {MEMCPY: 3e-06, "nvjet_tst_128x16_64x8": 5e-06,
                  "nvjet_tst_256x128_64x4": 3e-05, DATTN: 1.2e-05,
                  FLASH: 4e-05, ELEM: 2e-06},
    "by_range": {"decode": {"device_s": 1.9e-05, "launches": 3},
                 "other": {"device_s": 3e-06, "launches": 1},
                 "prefill": {"device_s": 7.000000000000001e-05,
                             "launches": 2}},
    "breakdown": {"device_ops": [[FLASH, 4e-05],
                                 ["nvjet_tst_256x128_64x4", 3e-05],
                                 [DATTN, 1.2e-05],
                                 ["nvjet_tst_128x16_64x8", 5e-06],
                                 [MEMCPY, 3e-06], [ELEM, 2e-06]],
                  "idle_gaps": [["repro_torch.serve.decode", 6.3e-05],
                                ["repro_torch.serve.prefill", 3e-05],
                                ["repro_torch.decode.attention", 2.9e-05],
                                ["repro_torch::decode_attn", 5e-06]]}}


@pytest.fixture(autouse=True)
def _few_threads():
    """Two CPU threads, so that this file leaves cores to the test workers
    beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _test_process_modules(monkeypatch):
    """A test worker may have imported JAX for the repository's other
    tests; the run's own look at ``sys.modules`` is held by
    ``test_cardbench_imports.py``."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def config(name, tiny=True):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    if tiny:
        cfg = harness._merged(cfg, TINY[name])
    mod = harness.load_module(HERE / "configs" / f"{name}.py",
                              "f_" + harness._ident(name))
    spec = mod.spec(cfg)
    return cfg, mod, spec, mod.layout(spec)


def bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32).numpy().tobytes()


# ------------------------------------------------------------ leaves

@pytest.mark.parametrize("key", LEAF_HASHES, ids=lambda k: "-".join(map(
    str, k)))
def test_existing_layouts_leaves_bit_for_bit(key):
    name, seed, dtype = key
    _, _, _, layout = config(name)
    h = hashlib.sha256()
    for i, (_, shape, init) in enumerate(layout):
        h.update(bits(weights.make_leaf(seed, i, shape, init, "cpu",
                                        getattr(torch, dtype))))
    assert h.hexdigest() == LEAF_HASHES[key]
    if dtype == "bfloat16":
        tree = weights.make_params(seed, layout, "cpu")
        h = hashlib.sha256()
        for path, *_ in layout:
            h.update(bits(weights.get(tree, path)))
        assert h.hexdigest() == LEAF_HASHES[key]


def test_sub_seeds_unchanged():
    for (seed, *tag), want in SUB_SEEDS.items():
        assert weights.sub_seed(seed, *tag) == want


INITS = [(("normal", 0.5), -4.0, 4.0), (("ones",), 1.0, 1.0),
         (("zeros",), 0.0, 0.0), (("const", -0.25), -0.25, -0.25),
         (("uniform", -0.5, 0.5), -0.5, 0.5),
         (("log_of_uniform", 1.0, 16.0), 0.0, 2.7726),
         (("softplus_inv_log_uniform", 1e-3, 0.1), -9.22, -2.25)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("init,lo,hi", INITS, ids=lambda v: str(v))
def test_initialiser_made_again_alone_and_in_range(init, lo, hi, dtype):
    layout = [("a", (3, 5), ("normal", 1.0)),
              ("b", (64, 32), init, dtype)]
    flat = weights.make_flat(SEED, layout, "cpu")
    got = flat["b"]
    assert got.dtype == getattr(torch, dtype)
    assert flat["a"].dtype == torch.bfloat16
    again = weights.make_leaf(SEED, 1, (64, 32), init, "cpu",
                              getattr(torch, dtype))
    assert torch.equal(got, again)
    assert lo - 1e-2 <= float(got.min()) and float(got.max()) <= hi + 1e-2
    if init[0] not in ("ones", "zeros", "const"):
        other = weights.make_leaf(SEED + 1, 1, (64, 32), init, "cpu",
                                  getattr(torch, dtype))
        assert not torch.equal(got, other)


def test_mamba2_dt_bias_is_softplus_inverse_of_a_floored_log_uniform_dt():
    x = weights.make_leaf(SEED, 0, (4096,), ("softplus_inv_log_uniform",
                                             1e-5, 0.1), "cpu", torch.float32)
    dt = torch.nn.functional.softplus(x.double())
    assert float(dt.min()) >= weights.DT_FLOOR * (1 - 1e-4)
    assert float(dt.max()) <= 0.1 * (1 + 1e-4)
    # a quarter of the log range lies under the floor, and is lifted to it
    floored = float((dt < weights.DT_FLOOR * 1.001).double().mean())
    assert 0.15 < floored < 0.35
    a = weights.make_leaf(SEED, 1, (4096,), ("log_of_uniform", 1.0, 16.0),
                          "cpu", torch.float32)
    assert float(a.exp().mean()) == pytest.approx(8.5, rel=0.05)


def test_unknown_initialiser_refused():
    with pytest.raises(ValueError, match="initialiser"):
        weights.make_leaf(SEED, 0, (2,), ("xavier", 1.0, 2.0), "cpu")


def test_stacks_the_configuration_names_compare_a_layer_at_a_time():
    spec = {"stacks": ["rec_blocks", "attn_blocks"]}
    keys = weights.stacks(spec)
    assert weights.slices("rec_blocks/rec/b_r", (3, 8), keys) == [
        ("rec_blocks/rec/b_r[0]", 0), ("rec_blocks/rec/b_r[1]", 1),
        ("rec_blocks/rec/b_r[2]", 2)]
    assert weights.slices("embed/tok", (8, 4), keys) == [
        ("embed/tok", Ellipsis)]
    assert weights.stacks({}) == ("blocks", "encoder", "decoder")
    assert len(weights.slices("decoder/norm1", (6, 8))) == 6


# ------------------------------------------------------ counts and cuts

@pytest.mark.parametrize("key", FLOPS, ids=lambda k: "-".join(map(str, k)))
def test_frozen_counts_at_the_cells_shapes(key):
    name, which, B, S = key
    _, mod, spec, layout = config(name, tiny=False)
    assert not hasattr(mod, which)
    assert counts.model_flops(mod, which, layout, spec, B, S) == FLOPS[key]
    assert getattr(counts, which)(layout, spec, B, S) == FLOPS[key]


def test_a_configurations_own_count_is_taken():
    _, _, spec, layout = config("deepseek-7b")
    own = NS(prefill_flops=lambda s, B, S: 7.0 * B * S)
    assert counts.model_flops(own, "prefill_flops", layout, spec, 2, 3) == 42.
    assert counts.model_flops(own, "train_model_flops", layout, spec, 2, 3) \
        == counts.train_model_flops(layout, spec, 2, 3)


@pytest.mark.parametrize("name", ["deepseek-7b", "seamless-m4t-large-v2"])
def test_first_configurations_give_the_same_model_config(name):
    """As the harness built it before cuts: the arch with the file's sizes
    and the run's settings."""
    from repro_torch.configs import get_arch
    cfg, _, spec, layout = config(name, tiny=False)
    run = cfg["run"]
    sizes = {"d_model": spec["d_model"], "n_heads": spec["heads"],
             "n_kv_heads": spec["kv_heads"], "head_dim": spec["head_dim"],
             "d_ff": spec["d_ff"], "vocab_size": spec["vocab"]}
    if spec["family"] == "encdec":
        sizes.update(enc_layers=spec["enc_layers"],
                     dec_layers=spec["dec_layers"],
                     n_layers=spec["enc_layers"] + spec["dec_layers"])
    else:
        sizes.update(n_layers=spec["layers"])
    want = dataclasses.replace(
        get_arch(run["program_arch"]), **sizes, param_dtype="bfloat16",
        attn_impl=run["attn_impl"], grad_compression=run["grad_compression"],
        remat=run["remat"], optimizer=run["optimizer"])
    got = program.model_config(cfg, spec, reduced=["optimizer"])
    assert got == want
    program.check_layout(got, layout)


def _deepseek_cut(cut, layers=10, **keys):
    """deepseek-7b's file with ``num_hidden_layers`` and ``keys`` changed
    and ``run.cut`` set -> (file, spec)."""
    cfg, mod, _, _ = config("deepseek-7b", tiny=False)
    cfg = harness._merged(cfg, dict(keys, num_hidden_layers=layers,
                                    run={"cut": cut}))
    return cfg, mod.spec(cfg)


def test_a_cut_in_reduced_is_taken_from_the_file():
    cfg, spec = _deepseek_cut({"n_layers": "num_hidden_layers"})
    mc = program.model_config(cfg, spec,
                              reduced=["optimizer", "num_hidden_layers"])
    assert mc.n_layers == 10 and mc.d_model == 4096


def test_a_cut_outside_reduced_is_refused():
    cfg, spec = _deepseek_cut({"n_layers": "num_hidden_layers"})
    with pytest.raises(ValueError, match="reduced"):
        program.model_config(cfg, spec, reduced=["optimizer"])


@pytest.mark.parametrize("field", ["d_ff", "head_dim", "not_a_field"])
def test_a_cut_of_a_width_or_of_no_size_is_refused(field):
    cfg, spec = _deepseek_cut({field: "intermediate_size"}, layers=30)
    with pytest.raises(ValueError, match="run.cut"):
        program.model_config(cfg, spec,
                             reduced=["optimizer", "intermediate_size"])


def test_every_size_but_the_cut_is_held_to_the_arch():
    cfg, spec = _deepseek_cut({})
    with pytest.raises(ValueError, match="differ"):
        program.model_config(cfg, spec, reduced=["num_hidden_layers"])
    cfg, spec = _deepseek_cut({"n_layers": "num_hidden_layers"},
                              intermediate_size=11000)
    with pytest.raises(ValueError, match="d_ff"):
        program.model_config(cfg, spec, reduced=["num_hidden_layers"])


# ------------------------------------------------------- the trace

def _kernel(name, dur):
    return NS(name=name, device=0, duration=dur)


def _ev(name, s, e, parent=None, kernels=(), thread=1, dev=DeviceType.CPU,
        ann=False):
    return NS(name=name, time_range=NS(start=s, end=e), cpu_parent=parent,
              kernels=list(kernels), thread=thread, device_type=dev,
              is_user_annotation=ann)


def synthetic_events():
    """A traced round: the benchmark's prefill and decode ranges, the
    program's spans inside them (the attention span nested in the decode
    step's), and a copy outside every range and span."""
    pre = _ev("cardbench.prefill", 0, 100)
    sp = _ev("repro_torch.serve.prefill", 1, 99, pre)
    mm = _ev("aten::mm", 2, 10, sp, [_kernel("nvjet_tst_256x128_64x4", 30.)])
    fl = _ev("repro_torch::flash_fwd", 11, 20, sp, [_kernel(FLASH, 40.)])
    dec = _ev("cardbench.decode", 100, 200)
    sd = _ev("repro_torch.serve.decode", 101, 199, dec)
    da = _ev("repro_torch.decode.attention", 102, 150, sd)
    mm2 = _ev("aten::mm", 103, 110, da, [_kernel("nvjet_tst_128x16_64x8",
                                                  5.)])
    at = _ev("repro_torch::decode_attn", 111, 120, da, [_kernel(DATTN, 12.)])
    add = _ev("aten::add", 151, 155, sd, [_kernel(ELEM, 2.)])
    cp = _ev("aten::copy_", 210, 220, None, [_kernel(MEMCPY, 3.)], thread=2)
    C = DeviceType.CUDA
    dev = [_ev("nvjet_tst_256x128_64x4", 5, 35, dev=C),
           _ev(FLASH, 36, 76, dev=C),
           _ev("nvjet_tst_128x16_64x8", 105, 110, dev=C),
           _ev(DATTN, 115, 127, dev=C), _ev(ELEM, 156, 158, dev=C),
           _ev(MEMCPY, 221, 224, dev=C),
           _ev("repro_torch.serve.decode", 101, 199, dev=C, ann=True),
           _ev("cardbench.decode", 100, 200, dev=C)]
    return [pre, sp, mm, fl, dec, sd, da, mm2, at, add, cp] + dev


def traced(monkeypatch, events):
    class Profile:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Profile())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return trace.run_traced(lambda: {"prefills": 1, "decode_steps": 1})


def test_record_fields_the_readers_take_are_as_on_the_parent(monkeypatch):
    rec = traced(monkeypatch, synthetic_events())
    for key, want in TRACE.items():
        assert rec[key] == want, key


def test_by_span_innermost_span_and_other(monkeypatch):
    rec = traced(monkeypatch, synthetic_events())
    assert rec["by_span"] == {
        "serve.prefill": {"launches": 2, "device_s": pytest.approx(7e-05)},
        "serve.decode": {"launches": 1, "device_s": pytest.approx(2e-06)},
        "serve.decode/decode.attention": {
            "launches": 2, "device_s": pytest.approx(1.7e-05)},
        "other": {"launches": 1, "device_s": pytest.approx(3e-06)}}
    assert readers.span_device({"trace": rec}, "serve.decode") == (
        3, pytest.approx(1.9e-05))
    assert readers.span_device({"trace": rec}, "decode.attention") == (
        2, pytest.approx(1.7e-05))
    assert readers.span_device({"trace": rec}, "train.step") is None


def test_by_span_three_deep_and_outside_any_span(monkeypatch):
    """A kernel counts once, in its innermost span; a span inside no
    benchmark range still counts; a launch in no span goes to other."""
    outer = _ev("repro_torch.a", 0, 100)
    mid = _ev("repro_torch.b", 1, 99, outer)
    inner = _ev("repro_torch.c", 2, 98, mid)
    op = _ev("aten::mm", 3, 4, inner, [_kernel("k1", 1.), _kernel("k2", 2.)])
    op2 = _ev("aten::add", 5, 6, outer, [_kernel("k3", 4.)])
    loose = _ev("aten::mul", 200, 201, None, [_kernel("k4", 8.)])
    dev = [_ev(n, s, s + 1, dev=DeviceType.CUDA)
           for n, s in (("k1", 10), ("k2", 20), ("k3", 30), ("k4", 300))]
    rec = traced(monkeypatch, [outer, mid, inner, op, op2, loose] + dev)
    assert rec["by_span"] == {
        "a/b/c": {"launches": 2, "device_s": pytest.approx(3e-06)},
        "a": {"launches": 1, "device_s": pytest.approx(4e-06)},
        "other": {"launches": 1, "device_s": pytest.approx(8e-06)}}
    assert rec["by_range"] == {
        "other": {"launches": 4, "device_s": pytest.approx(1.5e-05)}}
    assert readers.span_device({"trace": rec}, "b") == (2, pytest.approx(
        3e-06))
    assert readers.span_device({"trace": rec}, "a") == (3, pytest.approx(
        7e-06))


def test_program_counters_read_decode_attention_calls(monkeypatch):
    from repro_torch.kernels import decode_attention as da
    monkeypatch.setattr(da, "DECODE_ATTN_LAUNCHES", 17)
    assert program.counters()["decode_attn_calls"] == 17
    program.zero_counters()
    assert program.counters() == {"flash_fwd_calls": 0, "flash_bwd_calls": 0,
                                  "decode_attn_calls": 0}
    monkeypatch.delattr(da, "DECODE_ATTN_LAUNCHES")
    program.zero_counters()
    assert program.counters()["decode_attn_calls"] is None


# ------------------------------------------------------- the two readers

def reader(name):
    return harness.load_module(HERE / "metrics" / f"{name}.py",
                               "m_" + harness._ident(name))


def chat_record(per_step=30, attn_s=None, steps=4, by_span=True):
    """A traced chat sub-window: the cell's spec and mix, ``steps`` decode
    steps, ``per_step`` decode-attention calls counted a step (None: no
    counter), the decode_attn kernels at 80 % of their bound."""
    cfg, mod, spec, layout = config("deepseek-7b", tiny=False)
    mix = json.loads((HERE / "traffic" / "serve-chat.json").read_text())
    one = sum(counts.decode_attn_bound(16, 32, 32, 128, 1024 + j, 1152)
              for j in range(steps)) * 30
    by_name = {"nvjet_tst_128x16_64x8": 1.0}
    if attn_s is not False:
        by_name[DATTN] = one / 0.8 if attn_s is None else attn_s
    tr = {"info": {"prefills": 1, "decode_steps": steps},
          "counters": {"flash_fwd_calls": 30, "flash_bwd_calls": 0,
                       "decode_attn_calls": None if per_step is None
                       else per_step * steps},
          "by_name_s": by_name}
    if by_span:
        tr["by_span"] = {"serve.prefill": {"launches": 9, "device_s": 0.5},
                         "serve.decode": {"launches": 40, "device_s": 0.02},
                         "serve.decode/decode.attention": {
                             "launches": 8, "device_s": 0.02},
                         "other": {"launches": 3, "device_s": 0.1}}
    return {"kind": "serve", "spec": spec, "mix": mix,
            "attention_calls": mod.attention_calls(spec, 16, 1024),
            "trace": tr}


def test_decode_attn_roofline_is_the_bound_of_the_counted_calls():
    read = reader("decode_attn_roofline.serve").read
    assert read(chat_record()) == pytest.approx(80.0)
    # chat's 32 traced steps: 2.447 ms of bound a step (each valid K/V row
    # once), so 2.78-2.84 device ms a step read 86-88 %
    rec = chat_record(steps=32, attn_s=32 * 2.81e-3)
    assert read(rec) == pytest.approx(87.09, abs=0.01)


@pytest.mark.parametrize("case", ["no_kernel", "no_calls", "counter_missing",
                                  "calls_differ", "not_serve", "no_trace"])
def test_decode_attn_roofline_none(case):
    read = reader("decode_attn_roofline.serve").read
    rec = {"no_kernel": lambda: chat_record(attn_s=False),
           "no_calls": lambda: chat_record(per_step=0),
           "counter_missing": lambda: chat_record(per_step=None),
           "calls_differ": lambda: chat_record(per_step=29),
           "not_serve": lambda: dict(chat_record(), kind="train"),
           "no_trace": lambda: {k: v for k, v in chat_record().items()
                                if k != "trace"}}[case]()
    assert read(rec) is None


def test_decode_device_ms_is_the_decode_spans_device_time_a_step():
    read = reader("decode_device_ms.serve").read
    assert read(chat_record(steps=4)) == pytest.approx(1e3 * 0.04 / 4)


@pytest.mark.parametrize("case", ["no_span", "old_record", "not_serve",
                                  "no_steps", "no_trace"])
def test_decode_device_ms_none(case):
    read = reader("decode_device_ms.serve").read
    rec = chat_record()
    if case == "no_span":
        rec["trace"]["by_span"] = {"other": {"launches": 3, "device_s": .1}}
    elif case == "old_record":
        rec = chat_record(by_span=False)
    elif case == "not_serve":
        rec["kind"] = "train"
    elif case == "no_steps":
        rec["trace"]["info"]["decode_steps"] = 0
    else:
        del rec["trace"]
    assert read(rec) is None


# ------------------------------------------- whole runs of other families

PORT_REFERENCE = '''
"""A test configuration: the port's {family} decoder, whose reference is
the port's own fp32 forward on the CPU (the harness's plumbing is under
test here, not the model)."""
import dataclasses
import math

import torch

from cbench import program, weights


def spec(cfg):
    run = cfg["run"]
    return dict(cfg["sizes"], family=run["family"], arch=run["program_arch"],
                padded_vocab=run["padded_vocab_size"],
                optimizer=run["optimizer"],
                grad_compression=run["grad_compression"], remat=run["remat"])


def layout(s):
    d, L, V = s["d_model"], s["layers"], s["padded_vocab"]
    n = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))
    out = [("embed/tok", (V, d), ("normal", 0.02)),
           ("embed/head", (d, V), n(d)),
           ("embed/final_norm", (d,), ("ones",))]
    if s["family"] == "ssm":
        din, N = s["ssm_expand"] * d, s["ssm_state"]
        H = din // s["ssm_headdim"]
        return out + [
            ("blocks/ssm/w_in", (L, d, 2 * din + 2 * N + H), n(d)),
            ("blocks/ssm/conv", (L, s["conv_width"], din + 2 * N),
             ("uniform", -0.5, 0.5)),
            ("blocks/ssm/a_log", (L, H), ("log_of_uniform", 1.0, 16.0),
             "float32"),
            ("blocks/ssm/d_skip", (L, H), ("ones",), "float32"),
            ("blocks/ssm/dt_bias", (L, H),
             ("softplus_inv_log_uniform", 1e-3, 0.1), "float32"),
            ("blocks/ssm/w_out", (L, din, d), n(din)),
            ("blocks/ssm/out_norm", (L, din), ("ones",)),
            ("blocks/norm1", (L, d), ("ones",))]
    q, kv = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    E, ff = s["n_experts"], s["d_ff"]
    return out + [("blocks/norm1", (L, d), ("ones",)),
                  ("blocks/attn/wq", (L, d, q), n(d)),
                  ("blocks/attn/wk", (L, d, kv), n(d)),
                  ("blocks/attn/wv", (L, d, kv), n(d)),
                  ("blocks/attn/wo", (L, q, d), n(q)),
                  ("blocks/norm2", (L, d), ("ones",)),
                  ("blocks/moe/router", (L, d, E), n(d), "float32"),
                  ("blocks/moe/w_gate", (L, E, d, ff), n(d)),
                  ("blocks/moe/w_up", (L, E, d, ff), n(d)),
                  ("blocks/moe/w_down", (L, E, ff, d), n(ff))]


def input_shapes(s, B, S):
    return {{"tokens": ((B, S), "tokens")}}


def attention_calls(s, B, S):
    if s["family"] == "ssm":
        return []
    return [(B, s["heads"], s["head_dim"], S, S, True, s["layers"])]


{extra}


class Model:
    def __init__(self, s, prec="fp32"):
        from repro_torch.configs import get_arch
        arch = get_arch(s["arch"])
        fields = {{f.name for f in dataclasses.fields(arch)}}
        self.mc = dataclasses.replace(
            arch, **program.config_sizes(s, fields), param_dtype="float32",
            attn_impl="flash", remat=False)

    @torch.no_grad()
    def logits(self, params, tokens, rows):
        from repro_torch.models import layers as L
        from repro_torch.models.transformer import forward_train
        tree = weights.nested({{p: t.float() for p, t in params.items()}})
        h, _ = forward_train(tree, self.mc, {{"tokens": tokens}})
        return L.lm_logits(tree["embed"], h[:, rows]).float()
'''
MOE_FLOPS = '''
def prefill_flops(s, B, S):
    """k of the E experts a token, and the causal pairs of each layer."""
    d, ff, L = s["d_model"], s["d_ff"], s["layers"]
    q, kv = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    layer = 2 * d * q + 2 * d * kv + d * s["n_experts"] \\
        + s["experts_per_token"] * 3 * d * ff
    pairs = S * (S + 1) / 2
    return 2.0 * B * S * L * layer + 2.0 * B * d * s["padded_vocab"] \\
        + 4.0 * B * s["heads"] * s["head_dim"] * pairs * L
'''
FAMILIES = {
    "qwen3-moe-235b-a22b": {
        "run": {"family": "moe", "program_arch": "qwen3-moe-235b-a22b",
                "padded_vocab_size": 152064},
        "sizes": {"d_model": 4096, "layers": 94, "heads": 64, "kv_heads": 4,
                  "head_dim": 128, "d_ff": 1536, "vocab": 151936,
                  "n_experts": 128, "experts_per_token": 8,
                  "rope_theta": 1e6},
        # every expert a token, and room for every choice: no near-tie of
        # the router picks another expert in the bf16 program than in the
        # fp32 reference
        "smoke": {"sizes": {"d_model": 64, "layers": 2, "heads": 4,
                            "kv_heads": 2, "head_dim": 16, "d_ff": 32,
                            "vocab": 256, "n_experts": 4,
                            "experts_per_token": 4, "capacity_factor": 1.0},
                  "run": {"padded_vocab_size": 256}}},
    "mamba2-370m": {
        "run": {"family": "ssm", "program_arch": "mamba2-370m",
                "padded_vocab_size": 50432},
        "sizes": {"d_model": 1024, "layers": 48, "heads": 0, "kv_heads": 0,
                  "head_dim": 0, "d_ff": 0, "vocab": 50280, "ssm_state": 128,
                  "ssm_headdim": 64, "ssm_expand": 2, "ssm_chunk": 256,
                  "conv_width": 4},
        "smoke": {"sizes": {"d_model": 64, "layers": 2, "vocab": 256,
                            "ssm_state": 16, "ssm_headdim": 16,
                            "ssm_chunk": 8},
                  "run": {"padded_vocab_size": 256}}}}
MIX = {"kind": "serve_rounds", "batch": 4, "prompt_len": 16, "new_tokens": 9,
       "pad_to": 25, "zipf_s": 1.1, "sample_requests": 8,
       "trace_decode_steps": 2}


@pytest.fixture(scope="module")
def family_root(tmp_path_factory):
    """A root of its own: BENCHMARK.json, the two families' files and the
    seamless encoder-decoder's, a serving mix and each cell's limit."""
    root = tmp_path_factory.mktemp("families")
    here = root / "cardbench"
    for sub in ("configs", "traffic", "cells"):
        (here / sub).mkdir(parents=True)
    bench = {"configs": [], "workloads": [], "end_to_end": [],
             "per_layer": []}
    for name, fam in FAMILIES.items():
        run = dict(fam["run"], attn_impl="flash_pallas",
                   grad_compression=False, remat=False, optimizer="adafactor",
                   cut={"n_layers": "layers"})
        body = {"name": name, "source": "test", "sizes": fam["sizes"],
                "run": run}
        (here / "configs" / f"{name}.json").write_text(json.dumps(body))
        (here / "configs" / f"{name}.py").write_text(PORT_REFERENCE.format(
            family=fam["run"]["family"],
            extra=MOE_FLOPS if fam["run"]["family"] == "moe" else ""))
        bench["configs"].append({"name": name, "reduced": ["layers"]})
    sm = "seamless-m4t-large-v2"
    for ext in ("json", "py"):
        (here / "configs" / f"{sm}.{ext}").write_text(
            (HERE / "configs" / f"{sm}.{ext}").read_text())
    bench["configs"].append(next(c for c in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["configs"] if c["name"] == sm))
    (here / "traffic" / "serve-smoke.json").write_text(json.dumps(MIX))
    for name in list(FAMILIES) + [sm]:
        work = f"{name}.serve-smoke"
        bench["workloads"].append({"name": work, "config": name,
                                   "traffic": "serve-smoke", "chips": 1})
        (here / "cells" / f"{work}.json").write_text(json.dumps(
            {"limits": {"token_gap": 0.22}}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def family_cell(root, name, wrap=None, smoke=True):
    over = {"traffic": {}, "step_wrap": wrap}
    if smoke:
        over["config"] = (FAMILIES[name]["smoke"] if name in FAMILIES
                          else TINY[name])
    return harness.Cell(root, f"{name}.serve-smoke", SEED, 0.2, False, "cpu",
                        time.perf_counter(), overrides=over)


def dtypes_seen(seen):
    """A step_wrap that notes the dtype of every leaf the prefill gets."""
    def wrap(prefill, decode):
        def noted(params, batch):
            from repro_torch.tree import tree_items
            seen.update({p: t.dtype for p, t in tree_items(params)})
            return prefill(params, batch)
        return noted, decode
    return wrap


def altered_token(prefill, decode):
    def bad(params, cache, tok, pos):
        tok, logits, cache = decode(params, cache, tok, pos)
        return (tok + 1) % logits.shape[-1], logits, cache
    return prefill, bad


@pytest.mark.parametrize("name", FAMILIES)
def test_family_serves_correct_with_fp32_scalars(family_root, name):
    seen = {}
    cell = family_cell(family_root, name, dtypes_seen(seen))
    out = cell.run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4 and out["numbers"]["sampled_tokens"] >= 36
    fp32 = {p for p, dt in seen.items() if dt == torch.float32}
    want = ({"blocks/moe/router"} if name.startswith("qwen3") else
            {"blocks/ssm/a_log", "blocks/ssm/d_skip", "blocks/ssm/dt_bias"})
    assert fp32 == want
    window = out["record"]["window"]
    if name.startswith("qwen3"):
        assert window["prefill_flops"] == cell.refmod.prefill_flops(
            cell.spec, 4, 16)
    else:
        assert window["prefill_flops"] == counts.prefill_flops(
            cell.layout, cell.spec, 4, 16)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_with_an_altered_token_is_not_correct(family_root, name):
    out = family_cell(family_root, name, altered_token).run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_at_published_sizes_is_the_programs_arch(family_root, name):
    """Without overrides the file's sizes are held to the port's arch, the
    depth taken from the file as its cut; the layout, dtypes included, is
    the program's tree (shapes only, nothing is made)."""
    cell = family_cell(family_root, name, smoke=False)
    assert cell.mc.n_layers == FAMILIES[name]["sizes"]["layers"]
    assert cell.mc.d_model == FAMILIES[name]["sizes"]["d_model"]


def test_encoder_decoder_refused_by_serving_naming_its_inputs(family_root):
    cell = family_cell(family_root, "seamless-m4t-large-v2")
    with pytest.raises(ValueError, match="src_emb"):
        cell.run()

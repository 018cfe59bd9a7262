"""The metric arithmetic on synthetic timings (rates over the whole window,
95th percentiles over every request, idle shares from overlapping
intervals, the readers), and the frozen counts against the program's and
chip_smoke.py's at the cells' shapes (CPU, no card)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cbench import counts, harness, readers, trace, weights

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "cardbench"


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name):
    return load(HERE / "metrics" / f"{name}.py", "m_" + harness._ident(name))


def test_union_of_overlapping_intervals_and_gaps():
    iv = [(0, 10), (5, 12), (20, 25), (21, 22), (30, 31)]
    assert trace.union(iv) == 12 + 5 + 1
    assert trace.gaps(iv) == [(12, 20), (25, 30)]


def test_idle_gaps_named_by_innermost_host_event():
    cpu = [("outer", 0, 100, 1), ("aten::mm", 10, 15, 1),
           ("sync", 16, 40, 1), ("other_thread", 50, 60, 2)]
    got = trace.name_gaps([(18, 22), (52, 54), (90, 200)], cpu)
    assert got == pytest.approx({"sync": 4e-6, "other_thread": 2e-6,
                                 "python (no host op)": 110e-6})


def test_idle_share_over_host_span():
    rec = {"kind": "train", "trace": {"wall_s": 2.0, "busy_s": 1.5}}
    assert readers.idle_share(rec) == pytest.approx(25.0)
    assert reader("device_idle.train").read(rec) == pytest.approx(25.0)
    assert reader("device_idle.serve").read(rec) is None


def test_rate_and_tails_over_all_work(monkeypatch):
    """Three rounds of 2 requests of 3 tokens: the rate is every token over
    the window, the tails are over every token gap and every request."""
    from cbench import kind_serve_rounds
    clock = iter(np.arange(0.0, 100.0, 0.5))

    class Ctx:
        mix = {"batch": 2, "prompt_len": 4, "new_tokens": 3}

        class gen:
            @staticmethod
            def tokens(b, p, *tag):
                return torch.zeros((b, p), dtype=torch.int32)

    def fake_round(prefill, decode, params, prompts, n, clk):
        t = [next(clock) for _ in range(n + 1)]
        return torch.zeros((2, n), dtype=torch.int32), t[1:], t[0]

    monkeypatch.setattr(kind_serve_rounds, "serve_round", fake_round)
    monkeypatch.setattr(kind_serve_rounds.time, "perf_counter", lambda: 0.0)
    w = kind_serve_rounds.rounds(Ctx, None, None, None, count=3)
    assert w["rounds"] == 3 and len(w["finished"]) == 6
    assert len(w["tpot"]) == 3 * 2 * 2 and len(w["ttft"]) == 6
    assert np.percentile(w["ttft"], 95) == pytest.approx(0.5)
    assert set(w["tpot"]) == {0.5}


def test_train_mfu_reader_is_the_whole_window():
    rec = {"kind": "train", "window": {"steps": 10, "seconds": 20.0,
                                       "step_flops": 989e12}}
    assert reader("train_mfu").read(rec) == pytest.approx(50.0)


def test_elementwise_and_launch_readers():
    tr = {"by_category_s": {"elementwise_other": 0.2, "copy_cast": 0.1,
                            "reduce": 0.1, "gemm": 5.0},
          "info": {"steps": 2, "decode_steps": 4},
          "by_range": {"decode": {"launches": 400, "device_s": 0.1}}}
    assert reader("elementwise_ms.train").read(
        {"kind": "train", "trace": tr}) == pytest.approx(200.0)
    assert reader("decode_launches_per_step").read(
        {"kind": "serve", "trace": tr}) == pytest.approx(100.0)


def test_flash_share_counts_calls_and_time():
    call = (2, 32, 128, 4096, 4096, True, 30)
    one = counts.flash_fwd_bound(*call[:6])
    rec = {"kind": "train", "attention_calls": [call],
           "trace": {"counters": {"flash_fwd_calls": 60,
                                  "flash_bwd_calls": 0},
                     "by_name_s": {
                         "void (anonymous namespace)::flash_fwd_wg_kernel<128, "
                         "128>((anonymous namespace)::WgParams)": 100 * one,
                         "flash_fwd_tc_kernel": 20 * one,
                         "void at::native::flash_gemm": 1.0}}}
    assert reader("flash_fwd_roofline.train").read(rec) == pytest.approx(50.)
    assert reader("flash_bwd_roofline.train").read(rec) is None


def test_kernel_function_names():
    assert readers.kernel_function(
        "void (anonymous namespace)::flash_bwd_dkv_wg_kernel<64, false>("
        "(anonymous namespace)::WgParams)") == "flash_bwd_dkv_wg_kernel"
    assert readers.kernel_function("nvjet_tst_192x192_64x3") == \
        "nvjet_tst_192x192_64x3"


def test_category_table():
    assert trace.category("flash_bwd_dkv_wg_kernel") == "flash_bwd_dkv"
    assert trace.category("sm90_xmma_gemm_bf16") == "gemm"
    assert trace.category("vectorized_elementwise_kernel") == \
        "elementwise_other"


@pytest.mark.parametrize("S,Sk,causal", [(4096, 4096, True), (2056, 2056,
                         True), (2048, 2048, False), (333, 512, True)])
def test_allowed_pairs_frozen_copy(S, Sk, causal):
    from repro_torch.kernels import flash_attention as fa
    assert counts.allowed_pairs(S, Sk, causal) == fa.allowed_pairs(
        S, Sk, causal, 0, 0)


def _chip_smoke():
    return load(ROOT / "chip_smoke.py", "chip_smoke_frozen_check")


def _cell_layout(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    mod = load(HERE / "configs" / f"{name}.py", "c_" + harness._ident(name))
    spec = mod.spec(cfg)
    return cfg, spec, mod.layout(spec)


@pytest.mark.parametrize("name", ["deepseek-7b", "seamless-m4t-large-v2"])
def test_train_flops_equal_chip_smoke(name):
    from repro_torch.configs import get_arch
    from repro_torch.models import param_shapes
    cs = _chip_smoke()
    cfg, spec, layout = _cell_layout(name)
    arch = get_arch(cfg["run"]["program_arch"])
    want = cs.train_model_flops(arch, param_shapes(arch))
    assert counts.train_model_flops(layout, spec, cs.TRAIN_BATCH,
                                    cs.TRAIN_SEQ) == pytest.approx(want,
                                                                   rel=1e-12)


def test_bound_and_peaks_equal_chip_smoke():
    cs = _chip_smoke()
    assert counts.BF16_FLOP_PER_S == cs.BF16_FLOP_PER_S
    assert counts.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    for f, b in ((3e12, 1e9), (1e9, 5e10)):
        assert counts.bound(f, b) * 1e3 == pytest.approx(cs._bound(f, b)[0])


def test_flash_bounds_at_the_cells_shapes():
    """deepseek-7b's training shape: 0.2780 ms forward and 0.4170 + 0.5560
    ms for the backward pair, as PERF.md's kernel table gives them."""
    fwd = counts.flash_fwd_bound(2, 32, 128, 4096, 4096, True)
    bwd = counts.flash_bwd_bound(2, 32, 128, 4096, 4096, True)
    assert fwd * 1e3 == pytest.approx(0.2780, abs=1e-4)
    assert bwd * 1e3 == pytest.approx(0.4170 + 0.5560, abs=2e-4)


def test_layouts_are_the_programs_trees():
    from cbench import program
    for name in ("deepseek-7b", "seamless-m4t-large-v2"):
        cfg, spec, layout = _cell_layout(name)
        program.check_layout(program.model_config(cfg, spec), layout)


def test_weights_made_again_bit_for_bit():
    a = weights.make_leaf(2**31 + 99, 3, (4, 8), ("normal", 0.5), "cpu")
    b = weights.make_leaf(2**31 + 99, 3, (4, 8), ("normal", 0.5), "cpu")
    c = weights.make_leaf(2**31 + 99, 4, (4, 8), ("normal", 0.5), "cpu")
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert not torch.equal(a, c)

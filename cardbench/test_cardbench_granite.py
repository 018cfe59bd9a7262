"""granite-4.0-h-small in the harness (CPU, no card): the file at its
published sizes is the program's arch and tree with nothing cut; its own
prefill count; a whole ``Cell.run()`` of its chat cell at smoke widths,
correct, not correct with an altered token, and with the fp8 control in
the program's place."""
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from cbench import calibrate, counts, harness, weights

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "cardbench"
NAME = "granite-4.0-h-small"
CELL = f"{NAME}.serve-chat"
SEED = 2 ** 31 + 4099
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 32, "shared_intermediate_size": 48,
        "num_local_experts": 8, "num_experts_per_tok": 3, "vocab_size": 256,
        "num_hidden_layers": 3, "layer_types": ["mamba", "attention", "mamba"],
        "mamba_d_state": 16, "mamba_d_head": 16, "mamba_n_heads": 8,
        "mamba_chunk_size": 8, "run": {"padded_vocab_size": 256}}
MIX = {"batch": 4, "prompt_len": 20, "new_tokens": 6, "pad_to": 26,
       "sample_requests": 4, "trace_decode_steps": 2}
# At smoke widths the tied head's logits are small (a 64-wide row of the
# 0.005-std embedding, over 16): the bf16 program's served tokens read gaps
# of 0 to 2.4e-4 against the fp32 reference, a token picked one off 0.011
# to 0.015 (four seeds)
SMOKE_LIMIT = 3e-3


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    """A root of its own: the benchmark's files, the cell's limit set for
    smoke widths."""
    root = tmp_path_factory.mktemp("granite")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(HERE, root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    (root / "cardbench" / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"token_gap": SMOKE_LIMIT}}))
    return root


def cell(root, wrap=None, smoke=True):
    over = {"step_wrap": wrap}
    if smoke:
        over.update(config=TINY, traffic=MIX)
    return harness.Cell(root, CELL, SEED, 0.2, False, "cpu",
                        time.perf_counter(), overrides=over)


def test_published_sizes_are_the_programs_arch_with_nothing_cut():
    c = cell(ROOT, smoke=False)
    entry = next(e for e in c.bench["configs"] if e["name"] == NAME)
    assert entry["reduced"] == [] and "cut" not in c.cfg["run"]
    mc = c.mc
    assert (mc.n_layers, mc.d_model, mc.n_experts, mc.experts_per_token,
            mc.vocab_size, mc.padded_vocab()) == (40, 4096, 72, 10, 100352,
                                                  100352)
    assert mc.layer_types.count("attention") == 4 and mc.moe_dropless
    assert c.spec["stacks"] == ("ssm_blocks", "attn_blocks")
    n = sum(torch.Size(s).numel() for _, s, *_ in c.layout)
    assert n == mc.n_params() == 32_207_337_984
    fp32 = {p for p, *_, dt in map(weights.entry, c.layout)
            if dt == torch.float32}
    assert fp32 == {"ssm_blocks/ssm/a_log", "ssm_blocks/ssm/d_skip",
                    "ssm_blocks/ssm/dt_bias", "ssm_blocks/moe/router",
                    "attn_blocks/moe/router"}


def test_own_prefill_count():
    """The chat cell's prefill: 2 FLOPs for each of the 8.80 B weights a
    token passes through (8.39 B of them in the layers), the head on the
    last position, the chunked state-space products and the 4 layers'
    causal pairs; the harness takes it in place of ``counts``' formula,
    which would count all 72 experts."""
    c = cell(ROOT, smoke=False)
    B, S = 16, 1024
    got = counts.model_flops(c.refmod, "prefill_flops", c.layout, c.spec,
                             B, S)
    assert got == c.refmod.prefill_flops(c.spec, B, S)
    active_layers = c.mc.active_params() - 100352 * 4096 - 4096 \
        - 40 * 2 * 4096 - 36 * (3 * 128 + 8192 + 8448)
    ssd = 36 * B * 4 * 2.0 * (256 ** 2 * 128 + 2 * 128 * 256 ** 2 * 64)
    attn = 4 * 4.0 * B * 32 * 128 * S * (S + 1) / 2
    want = 2.0 * active_layers * B * S + 2.0 * 4096 * 100352 * B + ssd + attn
    assert got == pytest.approx(want, rel=1e-12)
    assert 2.8e14 < got < 3.0e14
    assert counts.prefill_flops(c.layout, c.spec, B, S) > 3 * got


def test_smoke_cell_serves_correct(smoke_root):
    out = cell(smoke_root).run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4
    assert out["numbers"]["sampled_tokens"] == 4 * MIX["new_tokens"]
    assert out["numbers"]["token_gap"] < SMOKE_LIMIT / 3


def _altered(prefill, decode):
    def bad(params, cache, tok, pos):
        tok, logits, cache = decode(params, cache, tok, pos)
        return (tok + 1) % logits.shape[-1], logits, cache
    return prefill, bad


def test_smoke_cell_with_an_altered_token_is_not_correct(smoke_root):
    out = cell(smoke_root, _altered).run()
    assert not out["correct"], out["checks"]


def test_fp8_control_runs_through_the_cell(smoke_root):
    """The fp8 control (the reference in fp8 in the program's place) runs
    a whole cell; whether it fails the limit is read at the cell's own
    size on the card (``calibrate.py``): at smoke widths it picks the fp32
    reference's tokens."""
    c = cell(smoke_root)
    c.step_wrap = calibrate.serve_control(c)
    out = c.run()
    assert out["attempted"] >= 4 and out["checks"]["token_gap"]["value"] >= 0

"""The harness with everything but its look for a card, at a size a test
run holds, on the program's CPU path: a sound run of each cell comes out
correct; the control (the fp8 reference in the program's place) and the
run with the timed path broken underneath come out not correct, once for
each fault the cell can have."""
import time
from pathlib import Path

import pytest
import torch

from cbench import calibrate, harness

ROOT = Path(__file__).resolve().parents[1]
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
# by workload: each mix cut to a test's size
MIX = {"seamless-m4t-large-v2.train-2x4k": {"batch": 2, "positions": 128},
       "deepseek-7b.serve-chat": {"batch": 4, "prompt_len": 16,
                                  "new_tokens": 8, "pad_to": 24,
                                  "sample_requests": 8},
       "deepseek-7b.serve-rag": {"batch": 4, "prompt_len": 24,
                                 "new_tokens": 8, "pad_to": 32,
                                 "sample_requests": 8}}
TRAIN = ["seamless-m4t-large-v2.train-2x4k"]
SERVE = ["deepseek-7b.serve-chat", "deepseek-7b.serve-rag"]
SEED = 2 ** 31 + 2718
CONTROL_SEEDS = (SEED, 11, 12)     # the control on three seeds, as on the card


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


def cell(workload, wrap=None, seed=SEED):
    return harness.Cell(ROOT, workload, seed, 0.2, False, "cpu",
                        time.perf_counter(),
                        overrides={"config": TINY[workload.split(".")[0]],
                                   "traffic": MIX[workload],
                                   "step_wrap": wrap})


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def unchanged_state(step):
    """A training step that returns its params and state as it found them."""
    def bad(params, state, batch):
        _, _, metrics = step(clone(params), clone(state), batch)
        return params, state, metrics
    return bad


def stale_cache(prefill, decode):
    """A decode step that leaves its cache as it found it."""
    def bad(params, cache, tok, pos):
        tok, logits, _ = decode(params, clone(cache), tok, pos)
        return tok, logits, cache
    return prefill, bad


def altered_token(prefill, decode):
    """A decode step whose token is altered where it is made."""
    def bad(params, cache, tok, pos):
        tok, logits, cache = decode(params, cache, tok, pos)
        return (tok + 1) % logits.shape[-1], logits, cache
    return prefill, bad


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_sound_run_is_correct(workload):
    out = cell(workload).run()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [unchanged_state, calibrate._half],
                         ids=["unchanged_state", "half_batch"])
def test_training_fault_is_not_correct(workload, fault):
    out = cell(workload, fault).run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("fault", [stale_cache, altered_token],
                         ids=["unchanged_state", "altered_token"])
def test_serving_fault_is_not_correct(workload, fault):
    out = cell(workload, fault).run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("workload", TRAIN)
def test_training_control_is_not_correct(workload, seed):
    c = cell(workload, seed=seed)
    c.step_wrap = calibrate.train_control(c)
    out = c.run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("workload", SERVE)
def test_serving_control_is_not_correct(workload, seed):
    c = cell(workload, seed=seed)
    c.step_wrap = calibrate.serve_control(c)
    out = c.run()
    assert not out["correct"], out["checks"]

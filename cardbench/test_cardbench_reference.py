"""The plain references against the program's own CPU path at smoke size,
in fp32 (every leaf's gradient, the loss, the serving logits through the
cache), and the reference's step tail (int8 compression, AdamW, Adafactor)
against the program's on the same numbers."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from cbench import harness, plain, weights

HERE = Path(__file__).resolve().parent
TINY = {"deepseek-7b": {"hidden_size": 64, "intermediate_size": 128,
                        "num_hidden_layers": 2, "num_attention_heads": 4,
                        "num_key_value_heads": 4, "vocab_size": 256,
                        "run": {"padded_vocab_size": 256}},
        "seamless-m4t-large-v2": {"hidden_size": 64, "encoder_layers": 2,
                                  "decoder_layers": 2,
                                  "encoder_attention_heads": 4,
                                  "decoder_attention_heads": 4,
                                  "encoder_ffn_dim": 128,
                                  "decoder_ffn_dim": 128, "vocab_size": 256,
                                  "run": {"padded_vocab_size": 256}}}


@pytest.fixture(autouse=True)
def _few_threads():
    """Two CPU threads, so that this file leaves cores to the test workers
    beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def setup(name):
    from cbench import program
    cfg = harness._merged(json.loads(
        (HERE / "configs" / f"{name}.json").read_text()), TINY[name])
    spec_ = importlib.util.spec_from_file_location(
        "r_" + harness._ident(name), HERE / "configs" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    spec = mod.spec(cfg)
    layout = mod.layout(spec)
    mc = dataclasses.replace(program.model_config(cfg, spec, False),
                             param_dtype="float32", attn_impl="flash",
                             remat=False, grad_compression=False)
    flat = {p: weights.make_leaf(7, i, s, init, "cpu", torch.float32)
            for i, (p, s, init) in enumerate(layout)}
    tree = {}
    for p, t in flat.items():
        *keys, last = p.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = t
    gen = torch.Generator().manual_seed(3)
    shapes = mod.input_shapes(spec, 2, 24)
    batch = {k: (torch.randint(0, 256, s, generator=gen, dtype=torch.int32)
                 if kind == "tokens" else torch.randn(s, generator=gen))
             for k, (s, kind) in shapes.items()}
    return mod, spec, layout, mc, flat, tree, batch


@pytest.mark.parametrize("name", ["deepseek-7b", "seamless-m4t-large-v2"])
def test_loss_and_every_gradient_match_the_program(name):
    from repro_torch.train import loss_and_grads
    mod, spec, layout, mc, flat, tree, batch = setup(name)
    loss_p, _, grads_p = loss_and_grads(tree, mc, batch)
    loss_r, grads_r = mod.Model(spec).loss_and_grads(flat, batch)
    assert loss_r == pytest.approx(float(loss_p), rel=1e-5)
    for path, _, _ in layout:
        got, want = weights.get(grads_p, path), grads_r[path]
        err = float((got - want).norm() / want.norm().clamp(min=1e-12))
        assert err < 1e-4, path


def test_serving_logits_match_prefill_and_decode():
    from repro_torch.serve import make_decode_step, make_prefill_step
    mod, spec, layout, mc, flat, tree, batch = setup("deepseek-7b")
    tokens = batch["tokens"][:, :16]
    prefill = make_prefill_step(mc, pad_to=24, device="cpu")
    decode = make_decode_step(mc, device="cpu")
    logits, cache = prefill(tree, {"tokens": tokens})
    seq, steps = [tokens], [logits[:, -1]]
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    for j in range(4):
        seq.append(tok)
        tok, lg, cache = decode(tree, cache, tok, 16 + j)
        steps.append(lg[:, -1])
    want = mod.Model(spec).logits(flat, torch.cat(seq, 1), slice(15, 20))
    got = torch.stack(steps, 1)
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_fp8_control_departs_from_fp32():
    mod, spec, layout, mc, flat, tree, batch = setup("deepseek-7b")
    a = mod.Model(spec, "fp32").logits(flat, batch["tokens"], slice(0, 24))
    b = mod.Model(spec, "fp8").logits(flat, batch["tokens"], slice(0, 24))
    rel = float((a - b).norm() / a.norm())
    assert 1e-3 < rel < 0.5


def test_compression_matches_the_program_bit_for_bit():
    from repro_torch.train.train_step import compress_grads
    gen = torch.Generator().manual_seed(5)
    g = {"a": torch.randn(3, 5000, generator=gen),
         "b": torch.randn(100, generator=gen),
         "z": torch.zeros(9000)}
    want = compress_grads({k: v.clone() for k, v in g.items()})
    plain.compress_(g)
    for k in g:
        assert torch.equal(g[k], want[k]), k


@pytest.mark.parametrize("name", ["adafactor", "adamw"])
def test_optimizer_matches_the_program(name):
    from repro_torch.train import opt_init, opt_update
    gen = torch.Generator().manual_seed(9)
    shapes = {"w": (3, 16, 24), "n": (3, 16), "f": (16,), "e": (40, 16)}
    params = {k: (torch.randn(s, generator=gen) * 0.1).to(torch.bfloat16)
              for k, s in shapes.items()}
    ref = {k: v.clone() for k, v in params.items()}
    st_p, st_r = opt_init(name, params), plain.opt_init(name, ref)
    for _ in range(3):
        grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
        opt_update(name, {k: v.clone() for k, v in grads.items()}, st_p,
                   params)
        plain.opt_update_(name, grads, st_r, ref)
    for k in shapes:
        diff = (params[k].float() - ref[k].float()).abs().max()
        assert float(diff) <= 2 ** -8 * float(ref[k].float().abs().max()), k

"""granite-4.0-h-small (the ssm_moe family) on the CPU at smoke size, fp32
params: the port's prefill, then decode through the two-kind cache,
against the plain reference's full forward (``cardbench/configs/
granite-4.0-h-small.py``, a sequential state-space recurrence, each expert
over its own tokens); dropless routing against a per-token loop and the
capacity path; each of granite's mechanisms shown to matter; the layer
order; the counters and spans; the parameter counts."""
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import init_model, param_count, param_shapes
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.attention_flash import blockwise_attention
from repro_torch.serve import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "cardbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))
from cbench import program, weights  # noqa: E402

NAME = "granite-4.0-h-small"
SEED = 2 ** 31 + 31
# the reference's JSON at smoke widths: d 64, 4 q / 2 kv heads of 16, 8
# experts (3 a token) of width 32 beside a shared expert of 48, 8 Mamba2
# heads of 16 over state 16, chunk 8
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 32, "shared_intermediate_size": 48,
        "num_local_experts": 8, "num_experts_per_tok": 3, "vocab_size": 256,
        "mamba_d_state": 16, "mamba_d_head": 16, "mamba_n_heads": 8,
        "mamba_chunk_size": 8, "run": {"padded_vocab_size": 256}}
ORDERS = {"mamba_attention_mamba": ["mamba", "attention", "mamba"],
          "attention_mamba_mamba_attention": ["attention", "mamba", "mamba",
                                              "attention"]}
# Both sides compute in fp32 from the same fp32 weights; they differ only
# in the order of their sums (the chunked scan against the step-by-step
# recurrence, blockwise softmax against plain, a grouped or batched expert
# product against one expert at a time).  Those orders move a logit by a
# few fp32 ulps of the values summed (~1e-7 relative over 4 layers); 1e-4
# of the largest logit is far above that and far below what any dropped
# mechanism moves (each test below reads at least 1e-2).
REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def reference_module():
    spec = importlib.util.spec_from_file_location(
        "granite_reference", BENCH / "configs" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup(order="mamba_attention_mamba"):
    """-> (reference module, spec, port cfg (fp32, blockwise attention),
    flat fp32 leaves, the port's tree)."""
    mod = reference_module()
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    types = ORDERS[order]
    cfg.update({k: v for k, v in TINY.items() if k != "run"},
               num_hidden_layers=len(types), layer_types=types)
    cfg["run"] = dict(cfg["run"], **TINY["run"])
    spec = mod.spec(cfg)
    mc = dataclasses.replace(program.model_config(cfg, spec, False),
                             param_dtype="float32", attn_impl="flash")
    layout = mod.layout(spec)
    program.check_layout(dataclasses.replace(mc, param_dtype="bfloat16"),
                         layout)
    flat = weights.make_flat(SEED, layout, "cpu", torch.float32)
    return mod, spec, mc, flat, weights.nested(flat)


def tokens(B=2, S=44, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B, S), generator=gen, dtype=torch.int32)


def served_logits(mc, tree, toks, prompt):
    """The port's logits at positions prompt-1 .. S-1: the prefill's last,
    then one decode step a token through the cache."""
    pre = make_prefill_step(mc, pad_to=toks.shape[1] + 2, device="cpu")
    dec = make_decode_step(mc, device="cpu")
    lg, cache = pre(tree, {"tokens": toks[:, :prompt]})
    out = [lg[:, 0]]
    for j in range(prompt, toks.shape[1]):
        _, lg, cache = dec(tree, cache, toks[:, j:j + 1], j)
        out.append(lg[:, 0])
    return torch.stack(out, dim=1), cache


def gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("order", ORDERS)
def test_prefill_then_decode_match_the_reference(order):
    """A 2 x 40 prompt (80 tokens: the grouped route, 5 chunks of 8) then
    4 decode steps (2 tokens: the batched route) through the two-kind
    cache, against the reference over the whole sequence."""
    mod, spec, mc, flat, tree = setup(order)
    toks = tokens()
    prompt = 40
    M.DROPLESS_CALLS.update(batched=0, grouped=0)
    got, cache = served_logits(mc, tree, toks, prompt)
    want = mod.Model(spec).logits(flat, toks, slice(prompt - 1, None))
    assert gap(got, want) < REL_TOL
    n_attn = ORDERS[order].count("attention")
    assert cache["state"].shape[0] == len(ORDERS[order]) - n_attn
    assert cache["k"].shape[0] == n_attn
    assert cache["state"].dtype == torch.float32
    n = len(ORDERS[order])
    assert M.DROPLESS_CALLS == {"grouped": n, "batched": 4 * n}


def test_layer_order_follows_layer_types():
    cfg = ARCHS[NAME]
    order = T.layer_order(cfg)
    assert [i for i, (t, _) in enumerate(order) if t == "attention"] == [
        5, 15, 25, 35]
    assert [j for t, j in order if t == "attention"] == [0, 1, 2, 3]
    assert [j for t, j in order if t == "mamba"] == list(range(36))
    # the same weights in another order give another model: the reference
    # follows the order it is given, and so does the port
    mod, spec, mc, flat, tree = setup()
    toks = tokens(S=12)
    swapped = dataclasses.replace(mc, layer_types=("mamba", "mamba",
                                                   "attention"))
    want = mod.Model(spec).logits(flat, toks, slice(None))
    got = served_logits(mc, tree, toks, 12)[0]
    assert gap(got[:, 0], want[:, -1]) < REL_TOL
    got_swapped = served_logits(swapped, tree, toks, 12)[0]
    assert gap(got_swapped[:, 0], want[:, -1]) > 1e-2


DROPS = ["conv_bias", "nope", "attention_multiplier", "embedding_multiplier",
         "residual_multiplier", "logits_scaling", "tied_head"]


@pytest.mark.parametrize("drop", DROPS)
def test_each_mechanism_matters(drop):
    """The port with one of granite's mechanisms left out misses the
    reference by far more than the tolerance: the comparison would catch
    a port that dropped it."""
    mod, spec, mc, flat, tree = setup()
    toks = tokens(S=20)
    want = mod.Model(spec).logits(flat, toks, slice(15, None))
    assert gap(served_logits(mc, tree, toks, 16)[0], want) < REL_TOL
    if drop == "conv_bias":
        tree["ssm_blocks"]["ssm"]["conv_bias"] = torch.zeros_like(
            tree["ssm_blocks"]["ssm"]["conv_bias"])
    elif drop == "nope":      # the sinusoidal table a rotary_pct 0 adds
        mc = dataclasses.replace(mc, nope=False)
    elif drop == "tied_head":
        mc = dataclasses.replace(mc, tie_embeddings=False)
        tree["embed"]["head"] = torch.randn(
            tree["embed"]["tok"].t().shape,
            generator=torch.Generator().manual_seed(1)) * 0.02
    else:
        mc = dataclasses.replace(mc, **{drop: 0.0 if drop ==
                                        "attention_multiplier" else 1.0})
    assert gap(served_logits(mc, tree, toks, 16)[0], want) > 1e-2


def test_tied_head_and_logits_scale_exactly():
    _, _, mc, _, tree = setup()
    assert "head" not in tree["embed"]
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(2))
    h = L.rms_norm(x, tree["embed"]["final_norm"], 1e-5)
    want = h @ tree["embed"]["tok"].t() / 16.0
    assert torch.equal(L.lm_logits(tree["embed"], x, mc), want)


# ------------------------------------------------ attention: NoPE, a scale

def _plain_attention(q, k, v, scale, causal=True):
    G = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S).triu(1).bool(), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("path", ["blockwise", "flash_twin"])
def test_set_scale_through_the_full_sequence_attention(path):
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 24, 8, 16, generator=gen)
    k, v = (torch.randn(2, 24, 2, 16, generator=gen) for _ in range(2))
    run = {"blockwise": lambda s: blockwise_attention(q, k, v, 2, scale=s,
                                                      bq=8, bk=8),
           "flash_twin": lambda s: flash_attention(q, k, v, 2, scale=s)}[path]
    want = _plain_attention(q, k, v, 1 / 128)
    assert gap(run(1 / 128), want) < 1e-5
    # the default scale, 1/sqrt(16), is another attention
    assert gap(run(None), want) > 1e-2
    assert gap(run(None), _plain_attention(q, k, v, 0.25)) < 1e-5


def test_set_scale_and_no_rope_through_the_decode_twin():
    gen = torch.Generator().manual_seed(4)
    B, S, Hq, Hkv, D, pos = 2, 12, 8, 2, 16, 9
    q = torch.randn(B, 1, Hq, D, generator=gen)
    k, v = (torch.randn(B, 1, Hkv, D, generator=gen) for _ in range(2))
    ck, cv = (torch.randn(B, S, Hkv, D, generator=gen) for _ in range(2))
    out = da.decode_attn_op(q, k, v, ck, cv, pos, 0.0, 1e4, False, 1 / 128)
    # the new k/v land in slot pos unrotated; slots <= pos are attended
    assert torch.equal(ck[:, pos:pos + 1], k)
    keys, vals = ck[:, :pos + 1], cv[:, :pos + 1]
    want = _plain_attention(q, keys, vals, 1 / 128, causal=False)
    assert gap(out, want) < 1e-5
    default = da.decode_attn_op(q, k, v, ck, cv, pos, 0.0, 1e4, False)
    assert gap(default, want) > 1e-2
    assert gap(default, _plain_attention(q, keys, vals, 0.25,
                                         causal=False)) < 1e-5


# ------------------------------------------------------- dropless routing

def _moe(E=8, k=3, T=40, seed=6):
    cfg = dataclasses.replace(smoke_variant(ARCHS[NAME]), n_experts=E,
                              experts_per_token=k, moe_dense_ff=0)
    gen = torch.Generator().manual_seed(seed)
    params = M.init_moe(gen, cfg)
    params["router"] = params["router"] * 50      # spread, no near-ties
    x = torch.randn(2, T // 2, cfg.d_model, generator=gen)
    return cfg, params, x


def _per_token(params, x, k):
    """Each token alone: its k largest router logits, a softmax over them,
    the k experts' SwiGLU weighted by it."""
    out = []
    for t in x.reshape(-1, x.shape[-1]):
        logits = t @ params["router"]
        top, idx = torch.topk(logits, k)
        g = torch.softmax(top, dim=0)
        y = sum(g[i] * ((torch.nn.functional.silu(t @ params["w_gate"][e])
                         * (t @ params["w_up"][e])) @ params["w_down"][e])
                for i, e in enumerate(idx.tolist()))
        out.append(y)
    return torch.stack(out).reshape(x.shape)


@pytest.mark.parametrize("T", [40, 120])
def test_dropless_matches_a_per_token_loop(T):
    """40 tokens take the batched route, 120 the grouped one."""
    cfg, params, x = _moe(T=T)
    M.DROPLESS_CALLS.update(batched=0, grouped=0)
    y, expert, _ = M.dropless_ffn(params, x, cfg)
    assert gap(y, _per_token(params, x, 3)) < 1e-5
    route = "batched" if T <= M.BATCHED_MAX_TOKENS else "grouped"
    assert M.DROPLESS_CALLS[route] == 1 and sum(
        M.DROPLESS_CALLS.values()) == 1


def test_dropless_equals_the_capacity_path_where_capacity_holds_every_token():
    cfg, params, x = _moe(T=120)
    want = M.dropless_ffn(params, x, cfg)[0]
    roomy = dataclasses.replace(cfg, moe_dropless=False,
                                capacity_factor=cfg.n_experts
                                / cfg.experts_per_token)
    xf = x.reshape(1, -1, cfg.d_model)
    assert bool(M.route(params["router"], xf, 3,
                        M._capacity(xf.shape[1], roomy)).keep.all())
    assert gap(M.moe_ffn(params, x, roomy)[0], want) < 1e-5


def test_dropless_drops_nothing_where_the_capacity_path_drops():
    """Every token's choices on one expert: the capacity path at its
    default factor keeps 8 slots of expert 0's 120 and drops the rest;
    dropless computes all 120."""
    cfg, params, x = _moe(T=120)
    params["router"][:, 0] += 1e4 * x.reshape(-1, cfg.d_model).mean(0)
    capped = dataclasses.replace(cfg, moe_dropless=False)
    xf = x.reshape(1, -1, cfg.d_model)
    r = M.route(params["router"], xf, 3, M._capacity(120, capped))
    assert not bool(r.keep.all())
    dropless = M.dropless_ffn(params, x, cfg)[0]
    want = _per_token(params, x, 3)
    assert gap(dropless, want) < 1e-5
    assert gap(M.moe_ffn(params, x, capped)[0], want) > 1e-2


def test_dropless_training_aux_and_gradients():
    """Through ``moe_ffn`` a dropless layer gives the Switch aux loss from
    the counts and the full softmax, and gradients reach every expert a
    token chose."""
    cfg, params, x = _moe(T=120)
    for p in params.values():
        p.requires_grad_()
    y, aux = M.moe_ffn(params, x, cfg)
    expert = M.dropless_route(params["router"], x.reshape(-1, 64), 3)[1]
    probs = torch.softmax(x.reshape(-1, 64) @ params["router"].detach(),
                          dim=-1)
    density = torch.bincount(expert.reshape(-1), minlength=8).float() / 120
    assert float(aux.detach()) == pytest.approx(
        float((density * probs.mean(0)).sum() * 8), rel=1e-6)
    (y.square().sum() + aux).backward()
    used = set(expert.reshape(-1).tolist())
    for e in range(8):
        assert bool(params["w_down"].grad[e].abs().sum() > 0) == (e in used)


# --------------------------------------------- registry, counters, spans

def test_params_counted_from_the_layout():
    cfg = ARCHS[NAME]
    assert cfg.n_params() == param_count(param_shapes(cfg)) == 32_207_337_984
    assert round(cfg.n_params() / 1e6) == 32207
    assert cfg.active_params() == cfg.n_params() - 40 * 62 * 3 * 4096 * 768
    smoke = smoke_variant(cfg)
    assert smoke.n_params() == param_count(param_shapes(smoke))
    assert smoke.layer_types.count("attention") >= 1 and smoke.n_experts >= 8


def test_counters_and_spans_of_a_served_round():
    mod, spec, mc, flat, tree = setup()
    toks = tokens(S=14)
    SSM.SSD_CALLS.update(prefill=0, decode=0)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        served_logits(mc, tree, toks, 12)
    rec = spans.record()
    assert SSM.SSD_CALLS == {"prefill": 2, "decode": 4}
    assert rec["prefill.ssm"]["count"] == 2
    assert rec["prefill.moe"]["count"] == 3
    assert rec["decode.ssm"]["count"] == 4
    assert rec["decode.moe"]["count"] == 6
    assert rec["decode.attention"]["count"] == 2
    spans.reset()


def test_smoke_train_step_runs():
    """``forward_train`` and the loss take the family: a finite loss and a
    gradient on both stacks and the tied embedding."""
    from repro_torch.train import loss_and_grads
    cfg = smoke_variant(ARCHS[NAME])
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, cfg, device="cpu")
    loss, _, grads = loss_and_grads(params, cfg, {"tokens": tokens(S=16)})
    assert math.isfinite(float(loss))
    for key in ("ssm_blocks", "attn_blocks"):
        assert float(grads[key]["moe"]["dense"]["w_down"].abs().sum()) > 0
    assert float(grads["embed"]["tok"].abs().sum()) > 0

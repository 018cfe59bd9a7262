"""Mamba2's decode recurrence (``kernels/ssd_decode.py``): the wrapper, its
plain twin and, on the card, its two kernels (``csrc/ssd_decode.cu``).

On the CPU: the wrapper is the twin (on CPU and meta tensors), the state
kernel's P split, the checks that refuse a shape before any launch, and the
call counter that decode-graph replays advance.  The tests marked ``gpu``
need an NVIDIA card and ``nvcc`` and skip elsewhere; run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd_decode.py``.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.kernels import ssd_decode as sd

# (B, H, N, P, K, conv bias): granite-4.0-h-small's rows at 1, chat's 16 and
# 64, and mamba2-370m's (no conv bias) at 4 and 16
SHAPES = {
    "granite_b1": (1, 128, 128, 64, 4, True),
    "granite_b16": (16, 128, 128, 64, 4, True),
    "granite_b64": (64, 128, 128, 64, 4, True),
    "mamba2_b4": (4, 32, 128, 64, 4, False),
    "mamba2_b16": (16, 32, 128, 64, 4, False),
}


def _inputs(shape, dtype, device, seed=0, bias=None):
    """proj, the layer's params, the fp32 state and the conv tail of one
    decode step at ``shape``, drawn from ``seed``: the conv taps and bias
    uniform in [-0.5, 0.5], A_log the log of U(1, 16), dt_bias the
    softplus inverse of a log-uniform dt in [1e-3, 0.1] (granite's init)."""
    B, H, N, P, K, with_bias = shape
    with_bias = with_bias if bias is None else bias
    C = H * P + 2 * N
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g)
    dt = torch.exp(math.log(1e-3) + u(H) * math.log(100.0))
    params = {"conv": (u(K, C) - 0.5).to(dtype),
              "dt_bias": dt + torch.log(-torch.expm1(-dt)),
              "a_log": torch.log(1.0 + 15.0 * u(H)),
              "d_skip": 0.5 + u(H)}
    if with_bias:
        params["conv_bias"] = (u(C) - 0.5).to(dtype)
    proj = torch.randn((B, 1, 2 * H * P + 2 * N + H), generator=g)
    state = torch.randn((B, H, N, P), generator=g)
    conv = torch.randn((B, K - 1, C), generator=g).to(dtype)
    to = lambda t: t.to(device)
    return (to(proj.to(dtype)), {k: to(v) for k, v in params.items()},
            to(state), to(conv))


# ------------------------------- CPU -------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_the_cpu_is_the_twin(dtype):
    proj, params, state, conv = _inputs((2, 4, 16, 8, 4, True), dtype, "cpu")
    state0, conv0 = state.clone(), conv.clone()
    before = sd.SSD_DECODE_LAUNCHES
    y, st, cv = sd.ssd_decode(proj, params, state, conv)
    want = sd.ssd_decode_reference(proj, params, state0, conv0)
    assert sd.SSD_DECODE_LAUNCHES == before
    assert y.dtype == dtype and tuple(y.shape) == (2, 1, 32)
    for got, w in zip((y, st, cv), want):
        assert torch.equal(got, w)
    # new tensors: the inputs are left as they were
    assert st is not state and cv is not conv
    assert torch.equal(state, state0) and torch.equal(conv, conv0)
    # the new tail is the old one shifted by one, the new x, B, C last
    assert torch.equal(cv[:, :-1], conv0[:, 1:])
    assert torch.equal(cv[:, -1], proj[:, 0, 32:32 + 64])


def test_wrapper_on_meta_is_the_twin():
    proj, params, state, conv = (
        t.to("meta") if isinstance(t, torch.Tensor)
        else {k: v.to("meta") for k, v in t.items()}
        for t in _inputs((2, 4, 16, 8, 4, False), torch.bfloat16, "cpu"))
    before = sd.SSD_DECODE_LAUNCHES
    y, st, cv = sd.ssd_decode(proj, params, state, conv)
    assert sd.SSD_DECODE_LAUNCHES == before
    assert (y.device.type, tuple(y.shape), y.dtype) \
        == ("meta", (2, 1, 32), torch.bfloat16)
    assert tuple(st.shape) == tuple(state.shape) and st.dtype == torch.float32
    assert tuple(cv.shape) == tuple(conv.shape)


@pytest.mark.parametrize("B, H, P, want", [
    (16, 128, 64, 64),     # granite chat: 2,048 blocks
    (64, 128, 64, 64),
    (1, 128, 64, 16),      # 128 heads alone: slices of 16, 512 blocks
    (4, 32, 64, 16),       # mamba2-370m at 4 rows
    (16, 32, 64, 64),      # mamba2-370m at 16 rows: 512 blocks
    (4, 8, 16, 16),        # the smoke models: no slice under 16
    (2, 4, 8, 8),          # P itself where it is under 16
    (2, 4, 12, 4),
    (1, 1, 256, 16),
    (64, 64, 256, 128),
])
def test_p_slice_from_the_shapes(B, H, P, want):
    got = sd.decode_p_slice(B, H, P)
    assert got == want and P % got == 0


def test_decode_graphs_replays_advance_the_launch_counter():
    from repro_torch.models import decode as D
    assert (sd, "SSD_DECODE_LAUNCHES") in D._COUNTED
    key = (sd, "SSD_DECODE_LAUNCHES", None)
    assert D._calls()[key] == sd.SSD_DECODE_LAUNCHES
    before = sd.SSD_DECODE_LAUNCHES
    try:
        D._advance({key: 3})
        assert sd.SSD_DECODE_LAUNCHES == before + 3
    finally:
        sd.SSD_DECODE_LAUNCHES = before


def test_wrapper_refuses_mismatched_shapes():
    proj, params, state, conv = _inputs((2, 4, 16, 8, 4, True),
                                        torch.float32, "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        sd.ssd_decode(proj[..., :-1], params, state, conv)
    with pytest.raises(ValueError, match="shape mismatch"):
        sd.ssd_decode(proj, params, state, conv[:, 1:])
    with pytest.raises(ValueError, match="shape mismatch"):
        sd.ssd_decode(proj, {**params, "conv_bias": params["conv_bias"][1:]},
                      state, conv)


def _meta_inputs(shape, dtype=torch.bfloat16, state=None, **params):
    """``_inputs`` on meta tensors, with ``state`` or params replaced."""
    proj, p, st, conv = _inputs(shape, dtype, "cpu")
    p.update(params)
    meta = lambda t: t.to("meta")
    return (meta(proj), {k: meta(v) for k, v in p.items()},
            meta(st if state is None else state), meta(conv))


# the card branch's refusals, before any launch: each changes one thing of
# a shape the kernels take
OK = (2, 4, 16, 8, 4, True)
REFUSED = {
    "p_not_a_multiple_of_4": lambda: _meta_inputs((2, 4, 16, 6, 4, True)),
    "state_too_large": lambda: _meta_inputs((1, 2, 2048, 8, 4, True)),
    "conv_too_wide": lambda: _meta_inputs((2, 4, 16, 8, 9, True)),
    "conv_of_one_tap": lambda: _meta_inputs((2, 4, 16, 8, 1, True)),
    "fp16": lambda: _meta_inputs(OK, torch.float16),
    "strided_state": lambda: _meta_inputs(
        OK, state=torch.zeros((2, 4, 8, 16)).transpose(2, 3)),
    "fp32_conv_under_bf16_proj": lambda: _meta_inputs(
        OK, conv=torch.zeros((4, 64))),
    "bf16_state": lambda: _meta_inputs(
        OK, state=torch.zeros((2, 4, 16, 8), dtype=torch.bfloat16)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_card_branch_refuses_what_the_kernels_cannot_take(case):
    proj, params, state, conv = REFUSED[case]()
    before = sd.SSD_DECODE_LAUNCHES
    with pytest.raises(ValueError, match="ssd_decode"):
        sd._launch(proj, params, state, conv)
    assert sd.SSD_DECODE_LAUNCHES == before


# ------------------------------- the card -------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _ulps(a, b) -> int:
    it = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return int((a.view(it).long() - b.view(it).long()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernels_match_the_twin(cuda, name, dtype, bias):
    """One decode step on the card against the twin on the same card.
    The conv tail is a copy, bit for bit.  The new state rounds as the
    twin's elementwise ops do (no fused multiply-add), so it may differ
    only where exp, log1p or the conv output do: within 2^-20 of the
    state's largest magnitude.  y differs by the readout's sum over N,
    taken in another order: each fp32 sum lies within (N - 1) 2^-24 of
    sum_n |C_n s_n| of the exact one, so the two within N 2^-23 of it, and
    y's rounding to its dtype adds at most one unit in the last place (in
    bf16 that is the whole difference wherever |y| is not small against
    sum_n |C_n s_n|)."""
    shape = SHAPES[name]
    B, H, N, P, K, _ = shape
    proj, params, state, conv = _inputs(shape, dtype, cuda, seed=B + H,
                                        bias=bias)
    conv0 = conv.clone()
    want_y, want_st, want_cv = sd.ssd_decode_reference(
        proj, params, state.clone(), conv.clone())
    before = sd.SSD_DECODE_LAUNCHES
    y, st, cv = sd.ssd_decode(proj, params, state, conv)
    torch.cuda.synchronize()
    assert sd.SSD_DECODE_LAUNCHES == before + 1
    assert st is state and cv is conv          # updated in place
    assert torch.equal(cv, want_cv)
    err = float((st - want_st).abs().max())
    assert err <= 2.0 ** -20 * float(want_st.abs().max()), err
    assert y.dtype == dtype and tuple(y.shape) == (B, 1, H * P)
    conv_out, _ = sd.causal_conv(proj[..., H * P:2 * H * P + 2 * N],
                                 params["conv"], conv0,
                                 params.get("conv_bias"))
    Cv = conv_out[:, 0, H * P + N:].float().abs()            # (B, N)
    mag = torch.einsum("bn,bhnp->bhp", Cv, want_st.abs())
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    tol = N * 2.0 ** -23 * mag.reshape(B, 1, H * P) \
        + ulp * want_y.float().abs()
    assert bool(((y.float() - want_y.float()).abs() <= tol).all())


@pytest.mark.gpu
def test_kernels_are_bit_equal_on_a_repeat(cuda):
    shape = SHAPES["granite_b16"]
    outs = []
    for _ in range(2):
        proj, params, state, conv = _inputs(shape, torch.bfloat16, cuda)
        y, st, cv = sd.ssd_decode(proj, params, state, conv)
        outs.append((y, st, cv))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernels_refuse_what_they_cannot_take_on_the_card(cuda):
    proj, params, state, conv = _inputs((2, 4, 16, 6, 4, True),
                                        torch.bfloat16, cuda)
    before = sd.SSD_DECODE_LAUNCHES
    with pytest.raises(ValueError, match="P a multiple of 4"):
        sd.ssd_decode(proj, params, state, conv)
    proj, params, state, conv = _inputs((2, 4, 16, 8, 4, True),
                                        torch.float16, cuda)
    with pytest.raises(ValueError, match="takes proj"):
        sd.ssd_decode(proj, params, state, conv)
    proj, params, state, conv = _inputs((2, 4, 16, 8, 4, True),
                                        torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="different devices"):
        sd.ssd_decode(proj, {**params, "a_log": params["a_log"].cpu()},
                      state, conv)
    assert sd.SSD_DECODE_LAUNCHES == before


@pytest.mark.gpu
def test_granite_widths_decode_graphs_replay_the_op_by_op_step(cuda):
    """granite-4.0-h-small's Mamba2 widths (d 4096: 128 heads of 64, state
    128, conv 4 with bias) in a 3-layer smoke stack (mamba, attention,
    mamba), bf16, chat's 16 rows: decode steps replayed from CUDA graphs
    give the op-by-op step's logits and cache bit for bit, and the
    kernels run once a Mamba2 layer a step, replayed or not."""
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import decode as D
    from repro_torch.models import forward_decode, init_model
    from repro_torch.models import layers as L
    from repro_torch.serve import make_decode_step, make_prefill_step
    cfg = dataclasses.replace(
        smoke_variant(ARCHS["granite-4.0-h-small"]), d_model=4096,
        ssm_state=128, ssm_headdim=64, param_dtype="bfloat16",
        attn_impl="flash")
    assert cfg.ssm_heads == 128
    n_ssm = cfg.layer_types.count("mamba")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_model(gen, cfg, device=cuda)
    prompt, slots, positions = 8, 20, range(8, 13)
    toks = torch.randint(0, cfg.vocab_size, (16, positions[-1] + 1),
                         generator=gen, device=cuda, dtype=torch.int32)
    _, cache_g = make_prefill_step(cfg, pad_to=slots, device=cuda)(
        params, {"tokens": toks[:, :prompt]})
    cache_e = {k: v.clone() for k, v in cache_g.items()}
    graphed = make_decode_step(cfg, device=cuda)
    replays = D.GRAPH_REPLAYS
    for pos in positions:
        tok = toks[:, pos:pos + 1]
        before = sd.SSD_DECODE_LAUNCHES
        _, lg_g, cache_g = graphed(params, cache_g, tok, pos)
        assert sd.SSD_DECODE_LAUNCHES == before + n_ssm
        before = sd.SSD_DECODE_LAUNCHES
        with torch.no_grad():
            h, cache_e = forward_decode(params, cfg, cache_e, tok, pos)
            lg_e = L.lm_logits(params["embed"], h, cfg)
        assert sd.SSD_DECODE_LAUNCHES == before + n_ssm
        assert torch.equal(lg_g, lg_e), pos
        for k in cache_e:
            assert torch.equal(cache_g[k], cache_e[k]), (pos, k)
    assert D.GRAPH_REPLAYS == replays + len(positions) - 1

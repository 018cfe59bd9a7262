"""The port's CUDA kernels on the card, against their plain torch versions:
flash attention forward and backward, int8 quantize / dequantize, and the
kernel paths of prefill and of a training step.

These need an NVIDIA card and ``nvcc`` (the kernels are built at first use)
and skip elsewhere.  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py``.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quantize as qz

pytestmark = pytest.mark.gpu

CASES = [
    # B, S, Hq, n_kv, D, causal, window, prefix
    (2, 64, 4, 2, 128, True, 0, 0),
    (2, 64, 4, 2, 80, True, 0, 0),
    (2, 96, 4, 1, 128, True, 32, 0),
    (2, 64, 4, 4, 128, True, 0, 16),
    (1, 64, 4, 4, 128, False, 0, 0),
    (1, 333, 6, 3, 256, True, 100, 0),   # ragged S, widest head dim
    (1, 130, 2, 2, 40, True, 0, 70),     # ragged S, narrow D, long prefix
    (2, 4096, 32, 32, 128, True, 0, 0),  # the training slice's shape
    (2, 200, 8, 2, 128, True, 0, 0),     # S not a multiple of the tiles
    (8, 256, 16, 16, 64, True, 0, 0),    # 512 blocks a pass: > 2 x 132 SMs
    (1, 70, 4, 2, 36, True, 0, 0),       # D % 8 != 0: 2-byte loads, no cp.async
    (1, 257, 4, 2, 256, False, 64, 0),   # widest D, window without causal
    (1, 300, 4, 1, 96, True, 50, 20),    # window and prefix together
    (4, 1024, 64, 4, 128, True, 0, 0),   # qwen3-moe serving: GQA, G = 16
    (2, 4096, 64, 4, 128, True, 0, 0),   # qwen3-moe training: G = 16
    (4, 1024, 16, 1, 256, True, 2048, 0),  # recurrentgemma serving: MQA
    (2, 4096, 16, 1, 256, True, 2048, 0),  # its training: the window bites
    (4, 512, 16, 16, 64, True, 0, 0),    # seamless serving: MHA, D = 64
    (4, 512, 16, 16, 64, False, 0, 0),   # its encoder: bidirectional
    (2, 2048, 16, 16, 64, True, 0, 0),   # seamless training
    (4, 1024, 8, 1, 256, True, 0, 256),  # paligemma serving: prefix 256
    (2, 4096, 8, 1, 256, True, 0, 256),  # paligemma training
    (1, 100, 4, 1, 256, True, 0, 0),     # D = 256, S ragged against 64 rows
    (3, 1024, 33, 11, 64, True, 0, 0),   # G = 3 in 2 chunks: 1 and 2 groups
]
# Cross-attention, bidirectional with Sq != Sk: (B, Sq, Sk, Hq, n_kv, D).
# seamless's decode identity (513 decoder queries over 512 encoder keys),
# ragged lengths either way, and D = 256 with G = 8.
CROSS_CASES = [
    (4, 513, 512, 16, 16, 64),
    (2, 2048, 1000, 16, 16, 64),
    (2, 200, 333, 4, 2, 128),
    (1, 77, 300, 8, 1, 256),
    (2, 333, 130, 8, 2, 256),            # D = 256, Sq > Sk, G = 4 chunked
]
# The forward's wgmma kernel (bf16, D in {64, 128, 256}) at the edges of its
# tiles and masks: (B, S, Hq, n_kv, D, causal, window, prefix[, Sk]).
WG_FWD_CASES = [
    (1, 333, 8, 2, 128, True, 0, 0),        # odd S: a ragged last q tile
    (1, 257, 4, 1, 64, True, 0, 0),         # odd S at D = 64
    (2, 257, 4, 2, 256, True, 0, 0),        # odd S at D = 256
    (4, 513, 16, 16, 64, False, 0, 0, 512),  # seamless's cross-attention
    (2, 200, 4, 2, 128, False, 0, 0, 333),  # Sq < Sk, ragged both
    (2, 333, 8, 2, 256, False, 0, 0, 130),  # Sq > Sk at D = 256
    (1, 1000, 16, 1, 256, True, 300, 0),    # window at D = 256, G = 16
    (2, 700, 8, 1, 256, True, 0, 256),      # prefix at D = 256, G = 8
    (1, 600, 8, 1, 256, True, 64, 40),      # window and prefix: a gap
    (1, 300, 4, 2, 128, False, 64, 0),      # window without causal
    (2, 1024, 64, 4, 128, True, 0, 0),      # G = 16
]
# fp32: the reference tests' 3e-4 (the scalar fp32 kernel).  bf16: the
# tensor-core kernel sums exact products of the bf16 inputs in fp32, rounds
# p to bf16 once as the operand of P.V and `out` once when stored (each at
# most 2^-9 relative).
TOL = {torch.float32: 3e-4, torch.bfloat16: 1e-2}
# Gradients.  fp32: the reference tests' 4e-3 (the fp32 kernels multiply
# in fp32 on the CUDA cores).  bf16: the tensor-core kernels sum the
# products in fp32, round p and ds to bf16 once as the operands of the
# second-stage products (p.dO, ds.k, ds.q) and dq/dk/dv once when stored,
# each rounding 2^-9 relative; held at 1e-2 relative plus 1e-2 of the
# largest |gradient| (sums over thousands of keys cancel).
GRAD_TOL = {torch.float32: (4e-3, 4e-3), torch.bfloat16: (1e-2, 1e-2)}
# The elementwise limits are loose for the late rows of a causal pass,
# whose values are far below the first rows'.  So out, dq, dk and dv are
# also held in 8 blocks of rows (dim -2): each block's norm of the
# difference over the plain version's norm (the bf16 roundings of p, ds
# and the output give 2.4-2.7e-3 in their emulation on the CPU,
# tests/test_torch_flash_bwd.py; fp32 differs only in summation order).
BLOCK_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


def _want_route(dtype, D):
    """The backward's route for the standard (model-layout) views."""
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if D in fa.WG_HEAD_DIMS else "mma"


def _assert_route(before, route):
    """One flash_bwd since ``before``: both passes on ``route``."""
    moved = {k: fa.BWD_ROUTE_LAUNCHES[k] - before[k] for k in before}
    assert moved == {k: 2 if k == route else 0 for k in before}, moved


def _assert_fwd_route(before, route):
    """One flash_fwd since ``before``, on ``route``."""
    moved = {k: fa.FWD_ROUTE_LAUNCHES[k] - before[k] for k in before}
    assert moved == {k: 1 if k == route else 0 for k in before}, moved


def _assert_row_blocks_close(got, want, dtype, name):
    for i, (g, w) in enumerate(zip(torch.tensor_split(got.float(), 8, -2),
                                   torch.tensor_split(want.float(), 8, -2))):
        rel = float((g - w).norm() / w.norm())
        assert rel <= BLOCK_REL_TOL[dtype], (name, i, rel)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_flash_fwd_kernel_matches_plain_version(cuda, case, dtype):
    B, S, Hq, n_kv, D, causal, window, prefix = case
    gen = torch.Generator(device=cuda).manual_seed(S * D)
    q = torch.randn((B, S, Hq, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, S, n_kv, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, S, n_kv, D), generator=gen, device=cuda).to(dtype)
    q5 = q.reshape(B, S, n_kv, Hq // n_kv, D).permute(0, 2, 3, 1, 4)
    k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    before, routes = fa.LAUNCHES, dict(fa.FWD_ROUTE_LAUNCHES)
    out, lse = fa.flash_fwd(q5, k4, v4, causal=causal, window=window,
                            prefix=prefix)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    _assert_fwd_route(routes, _want_route(dtype, D))
    ref_out, ref_lse = fa.flash_fwd_reference(
        q5.float(), k4.float(), v4.float(), causal=causal, window=window,
        prefix=prefix)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
    _assert_row_blocks_close(out, ref_out, dtype, "out")


@pytest.mark.parametrize("view", ["q_offset", "k_offset", "v_offset",
                                  "kv_row_pitch"])
def test_flash_fwd_bf16_unaligned_views_match_plain_version(cuda, view):
    """Views that are not 16-byte aligned (a data pointer 2 bytes past a
    16-byte boundary, or k/v rows 132 elements apart) take the kernel's
    2-byte loads at D == 128, the instance with no column guards."""
    B, S, Hq, n_kv, D = 2, 200, 8, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(5)

    def make(shape, name):
        if view == f"{name}_offset":
            n = shape[0] * shape[1] * shape[2] * shape[3]
            buf = torch.randn(n + 1, generator=gen, device=cuda)
            return buf.to(torch.bfloat16)[1:].view(shape)
        if view == "kv_row_pitch" and name in ("k", "v"):
            wide = torch.randn((*shape[:3], D + 4), generator=gen,
                               device=cuda)
            return wide.to(torch.bfloat16)[..., :D]
        return torch.randn(shape, generator=gen, device=cuda) \
            .to(torch.bfloat16)

    q = make((B, S, Hq, D), "q")
    k = make((B, S, n_kv, D), "k")
    v = make((B, S, n_kv, D), "v")
    q5 = q.reshape(B, S, n_kv, Hq // n_kv, D).permute(0, 2, 3, 1, 4)
    k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    assert any(t.data_ptr() % 16 or any(st % 8 for st in t.stride())
               for t in (q5, k4, v4))
    before, routes = fa.LAUNCHES, dict(fa.FWD_ROUTE_LAUNCHES)
    out, lse = fa.flash_fwd(q5, k4, v4, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    _assert_fwd_route(routes, "mma")
    ref_out, ref_lse = fa.flash_fwd_reference(q5.float(), k4.float(),
                                              v4.float(), causal=True)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
    _assert_row_blocks_close(out, ref_out, torch.bfloat16, "out")


def test_flash_fwd_bf16_kernel_takes_a_negative_scale(cuda):
    """A negative scale runs the tensor-core kernels on a negated q tile
    with |scale|: held against the plain version at the bf16 limits,
    causal and windowed, on the wgmma route at D = 128, 256 and 64 (each
    consumer warpgroup negates its q rows in shared memory) and on the mma
    route at D = 80."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for B, S, H, D, window in [(2, 200, 4, 128, 0), (1, 300, 2, 80, 64),
                               (1, 300, 1, 256, 64), (1, 257, 2, 64, 0)]:
        q, k, v = (torch.randn(shape, device=cuda, generator=g)
                   .to(torch.bfloat16)
                   for shape in [(B, H, 2, S, D), (B, H, S, D),
                                 (B, H, S, D)])
        scale = -1.0 / D ** 0.5
        before, routes = fa.LAUNCHES, dict(fa.FWD_ROUTE_LAUNCHES)
        out, lse = fa.flash_fwd(q, k, v, causal=True, window=window,
                                scale=scale)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before + 1
        _assert_fwd_route(routes, _want_route(torch.bfloat16, D))
        ref_out, ref_lse = fa.flash_fwd_reference(
            q.float(), k.float(), v.float(), causal=True, window=window,
            scale=scale)
        tol = TOL[torch.bfloat16]
        torch.testing.assert_close(out.float(), ref_out, rtol=tol, atol=tol)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
        _assert_row_blocks_close(out, ref_out, torch.bfloat16, "out")


def test_flash_fwd_fp32_kernel_takes_a_negative_scale(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((1, 2, 2, 40, 64), device=cuda, generator=g)
    k = torch.randn((1, 2, 40, 64), device=cuda, generator=g)
    v = torch.randn((1, 2, 40, 64), device=cuda, generator=g)
    out, lse = fa.flash_fwd(q, k, v, causal=True, scale=-0.125)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, causal=True,
                                              scale=-0.125)
    tol = TOL[torch.float32]
    torch.testing.assert_close(out, ref_out, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)


def _wg_fwd_inputs(case, cuda, seed):
    B, S, Hq, n_kv, D, causal, window, prefix = case[:8]
    Sk = case[8] if len(case) > 8 else S
    gen = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=cuda) \
        .to(torch.bfloat16)
    q5 = mk(B, S, Hq, D).reshape(B, S, n_kv, Hq // n_kv, D) \
        .permute(0, 2, 3, 1, 4)
    k4 = mk(B, Sk, n_kv, D).permute(0, 2, 1, 3)
    v4 = mk(B, Sk, n_kv, D).permute(0, 2, 1, 3)
    return (q5, k4, v4), dict(causal=causal, window=window, prefix=prefix)


def _assert_fwd_close(got, want):
    out, lse = got
    ref_out, ref_lse = want
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
    _assert_row_blocks_close(out, ref_out, torch.bfloat16, "out")


@pytest.mark.parametrize("case", WG_FWD_CASES)
def test_flash_fwd_wgmma_route_matches_plain_version(cuda, case):
    """The wgmma forward at odd S, Sq != Sk, window and prefix at D = 256
    (and both, which leave a gap of masked tiles), and G = 16: on its
    route, at the bf16 limits."""
    (q5, k4, v4), mask = _wg_fwd_inputs(case, cuda, sum(case[:5]))
    routes = dict(fa.FWD_ROUTE_LAUNCHES)
    got = fa.flash_fwd(q5, k4, v4, **mask)
    torch.cuda.synchronize()
    _assert_fwd_route(routes, "wgmma")
    _assert_fwd_close(got, fa.flash_fwd_reference(
        q5.float(), k4.float(), v4.float(), **mask))


def test_flash_fwd_wgmma_route_is_bit_equal_on_a_repeat(cuda):
    """Each output row has one writer and a fixed order of tiles: the same
    inputs give the same bits, at a training shape of each D."""
    for case in [(2, 2048, 16, 16, 64, True, 0, 0),
                 (2, 4096, 64, 4, 128, True, 0, 0),
                 (2, 4096, 16, 1, 256, True, 2048, 0)]:
        (q5, k4, v4), mask = _wg_fwd_inputs(case, cuda, 3)
        routes = dict(fa.FWD_ROUTE_LAUNCHES)
        first = fa.flash_fwd(q5, k4, v4, **mask)
        second = fa.flash_fwd(q5, k4, v4, **mask)
        torch.cuda.synchronize()
        moved = {k: fa.FWD_ROUTE_LAUNCHES[k] - routes[k] for k in routes}
        assert moved == {"wgmma": 2, "mma": 0, "fp32": 0}
        assert torch.equal(first[0], second[0]), case
        assert torch.equal(first[1], second[1]), case


def test_flash_fwd_kernel_refuses_a_strided_last_dim(cuda):
    q = torch.randn((1, 1, 1, 8, 32), device=cuda)[..., ::2]
    k = torch.randn((1, 1, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        fa.flash_fwd(q, k, k)


def test_prefill_through_the_kernel_matches_blockwise(cuda):
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import forward_prefill, init_model
    cfg = dataclasses.replace(smoke_variant(ARCHS["chatglm3-6b"]),
                              attn_impl="flash_pallas")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_model(gen, cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                           device=cuda, dtype=torch.int32)
    before = fa.LAUNCHES
    h_kernel, c_kernel = forward_prefill(params, cfg, {"tokens": tokens})
    assert fa.LAUNCHES == before + cfg.n_layers
    h_plain, c_plain = forward_prefill(
        params, dataclasses.replace(cfg, attn_impl="flash"),
        {"tokens": tokens})
    torch.testing.assert_close(h_kernel, h_plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c_kernel["k"], c_plain["k"])


def _bwd_inputs(case, dtype, cuda):
    B, S, Hq, n_kv, D, causal, window, prefix = case
    gen = torch.Generator(device=cuda).manual_seed(S + D)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=cuda) \
        .to(dtype)
    q, do = mk(B, S, Hq, D), mk(B, S, Hq, D)
    k, v = mk(B, S, n_kv, D), mk(B, S, n_kv, D)
    five = lambda x: x.reshape(B, S, n_kv, Hq // n_kv, D) \
        .permute(0, 2, 3, 1, 4)
    q5, do5 = five(q), five(do)
    k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = dict(causal=causal, window=window, prefix=prefix)
    # the forward kernel's own out and lse, as a training step feeds them
    out, lse = fa.flash_fwd(q5, k4, v4, **mask)
    delta = (do5.float() * out.float()).sum(-1)
    return (q5, k4, v4, do5, lse, delta), mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_kernels_match_plain_version(cuda, case, dtype):
    args, mask = _bwd_inputs(case, dtype, cuda)
    before = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    routes = dict(fa.BWD_ROUTE_LAUNCHES)
    got = fa.flash_bwd(*args, **mask)
    torch.cuda.synchronize()
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    _assert_route(routes, _want_route(dtype, case[4]))
    q5, k4, v4, do5, lse, delta = args
    want = fa.flash_bwd_reference(q5.float(), k4.float(), v4.float(),
                                  do5.float(), lse, delta, **mask)
    rtol, atol = GRAD_TOL[dtype]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape
        scale = 1.0 if dtype == torch.float32 else float(w.abs().max())
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=atol * scale, msg=name)
        _assert_row_blocks_close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CROSS_CASES)
def test_flash_kernels_at_sq_ne_sk_match_plain_version(cuda, case, dtype):
    """The forward kernel and then the backward pair fed its own out and
    lse, bidirectional, queries and keys of different lengths, each
    against its plain version elementwise and in 8 row blocks."""
    B, Sq, Sk, Hq, n_kv, D = case
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=cuda) \
        .to(dtype)
    five = lambda x: x.reshape(B, Sq, n_kv, Hq // n_kv, D) \
        .permute(0, 2, 3, 1, 4)
    q5, do5 = five(mk(B, Sq, Hq, D)), five(mk(B, Sq, Hq, D))
    k4 = mk(B, Sk, n_kv, D).permute(0, 2, 1, 3)
    v4 = mk(B, Sk, n_kv, D).permute(0, 2, 1, 3)
    mask = dict(causal=False, window=0, prefix=0)
    out, lse = fa.flash_fwd(q5, k4, v4, **mask)
    ref_out, ref_lse = fa.flash_fwd_reference(q5.float(), k4.float(),
                                              v4.float(), **mask)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
    _assert_row_blocks_close(out, ref_out, dtype, "out")
    delta = (do5.float() * out.float()).sum(-1)
    routes = dict(fa.BWD_ROUTE_LAUNCHES)
    got = fa.flash_bwd(q5, k4, v4, do5, lse, delta, **mask)
    _assert_route(routes, _want_route(dtype, D))
    want = fa.flash_bwd_reference(q5.float(), k4.float(), v4.float(),
                                  do5.float(), lse, delta, **mask)
    rtol, atol = GRAD_TOL[dtype]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        scale = 1.0 if dtype == torch.float32 else float(w.abs().max())
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=atol * scale, msg=name)
        _assert_row_blocks_close(g, w, dtype, name)


@pytest.mark.parametrize("view", ["q_offset", "do_offset", "kv_row_pitch"])
def test_flash_bwd_unaligned_views_take_the_mma_route(cuda, view):
    """bf16 at D = 128, but a view TMA cannot read (a pointer 2 bytes past
    a 16-byte boundary, or k/v rows 132 values apart): the mma.sync
    kernels run it, at the bf16 limits."""
    B, S, Hq, n_kv, D = 2, 200, 8, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(6)

    def make(shape, name):
        if view == f"{name}_offset":
            buf = torch.randn(math.prod(shape) + 1, generator=gen,
                              device=cuda)
            return buf.to(torch.bfloat16)[1:].view(shape)
        if view == "kv_row_pitch" and name in ("k", "v"):
            wide = torch.randn((*shape[:3], D + 4), generator=gen,
                               device=cuda)
            return wide.to(torch.bfloat16)[..., :D]
        return torch.randn(shape, generator=gen, device=cuda) \
            .to(torch.bfloat16)

    five = lambda x: x.reshape(B, S, n_kv, Hq // n_kv, D) \
        .permute(0, 2, 3, 1, 4)
    q5, do5 = five(make((B, S, Hq, D), "q")), five(make((B, S, Hq, D), "do"))
    k4 = make((B, S, n_kv, D), "k").permute(0, 2, 1, 3)
    v4 = make((B, S, n_kv, D), "v").permute(0, 2, 1, 3)
    out, lse = fa.flash_fwd(q5, k4, v4, causal=True)
    delta = (do5.float() * out.float()).sum(-1)
    routes = dict(fa.BWD_ROUTE_LAUNCHES)
    got = fa.flash_bwd(q5, k4, v4, do5, lse, delta, causal=True)
    torch.cuda.synchronize()
    _assert_route(routes, "mma")
    want = fa.flash_bwd_reference(q5.float(), k4.float(), v4.float(),
                                  do5.float(), lse, delta, causal=True)
    rtol, atol = GRAD_TOL[torch.bfloat16]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=atol * float(w.abs().max()), msg=name)
        _assert_row_blocks_close(g, w, torch.bfloat16, name)


def test_flash_bwd_is_deterministic_with_the_group_split(cuda):
    """qwen3-moe's training shape (G = 16 query heads a KV head, its
    groups split over 3 chunks of blocks in the dk/dv pass): two runs on
    the same inputs give the same bits in dq, dk and dv."""
    case = (2, 4096, 64, 4, 128, True, 0, 0)
    assert fa._dkv_chunks(2, 4, 16, 4096, 128) == 3
    args, mask = _bwd_inputs(case, torch.bfloat16, cuda)
    routes = dict(fa.BWD_ROUTE_LAUNCHES)
    first = fa.flash_bwd(*args, **mask)
    second = fa.flash_bwd(*args, **mask)
    torch.cuda.synchronize()
    moved = {k: fa.BWD_ROUTE_LAUNCHES[k] - routes[k] for k in routes}
    assert moved == {"wgmma": 4, "mma": 0, "fp32": 0}
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


def _groups(cuda, dtype, n_groups=64):
    gen = torch.Generator(device=cuda).manual_seed(n_groups)
    x = torch.randn((n_groups, qz.GROUP), generator=gen, device=cuda) * 3
    x[1] = 0.0                                     # all-zero group
    x[2] = torch.randint(-126, 126, (qz.GROUP,), generator=gen,
                         device=cuda) + 0.5        # exact .5 ties
    x[2, 0] = 127.0
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernels_bit_exact_with_plain_version(cuda, dtype):
    x = _groups(cuda, dtype)
    before = (qz.QUANT_LAUNCHES, qz.DEQUANT_LAUNCHES)
    q, s = qz.quantize(x)
    back = qz.dequantize(q, s)
    back16 = qz.dequantize(q, s, torch.bfloat16)
    torch.cuda.synchronize()
    assert (qz.QUANT_LAUNCHES, qz.DEQUANT_LAUNCHES) == \
        (before[0] + 1, before[1] + 2)
    q_ref, s_ref = qz.quantize_reference(x)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    assert float(s[1, 0]) == 1.0 and not bool(q[1].any())
    assert torch.equal(back, qz.dequantize_reference(q_ref, s_ref))
    assert torch.equal(back16.view(torch.int16),
                       qz.dequantize_reference(q_ref, s_ref, torch.bfloat16)
                       .view(torch.int16))


def test_custom_ops_launch_the_kernels(cuda):
    """On the card the custom ops are the wrappers: each call launches its
    kernel once (the counters move) and returns what the wrapper returns,
    strides included."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 2, 3, 96, 64), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    k, v = (torch.randn((2, 2, 96, 64), generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    mask = dict(causal=True, window=40, prefix=8)
    before = fa.LAUNCHES
    out, lse = fa.flash_fwd_op(q, k, v, True, 40, 8, 0.125)
    assert fa.LAUNCHES == before + 1
    ref_out, ref_lse = fa.flash_fwd(q, k, v, scale=0.125, **mask)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert out.stride() == ref_out.stride()
    delta = torch.randn(lse.shape, generator=gen, device=cuda)
    before = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    grads = fa.flash_bwd_op(q, k, v, q, lse, delta, True, 40, 8, 0.125)
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    for got, want in zip(grads, fa.flash_bwd(q, k, v, q, lse, delta,
                                             scale=0.125, **mask)):
        assert torch.equal(got, want) and got.stride() == want.stride()
    x = _groups(cuda, torch.bfloat16)
    before = (qz.QUANT_LAUNCHES, qz.DEQUANT_LAUNCHES)
    qq, ss = qz.quantize_op(x)
    back = qz.dequantize_op(qq, ss, torch.float32)
    assert (qz.QUANT_LAUNCHES, qz.DEQUANT_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    q_ref, s_ref = qz.quantize(x)
    assert torch.equal(qq, q_ref) and torch.equal(ss, s_ref)
    assert torch.equal(back, qz.dequantize(q_ref, s_ref))


def test_kernel_path_grads_match_blockwise(cuda):
    """The autograd Function on the card: forward and both backward
    kernels, against autograd through the plain blockwise path (fp32)."""
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.models.attention_flash import blockwise_attention
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, S, Hq, n_kv, D = 2, 200, 8, 2, 64
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda)
                   for shape in ((B, S, Hq, D), (B, S, n_kv, D),
                                 (B, S, n_kv, D), (B, S, Hq, D)))
    grads = {}
    for name, fn in (("kernel", lambda *a: flash_attention(*a, n_kv, True)),
                     ("plain", lambda *a: blockwise_attention(
                         *a, n_kv, causal=True, bq=40, bk=40))):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        if name == "kernel":
            assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        out.backward(do)
        grads[name] = [t.grad for t in ts]
    for a, b, name in zip(grads["kernel"], grads["plain"], "qkv"):
        torch.testing.assert_close(a, b, rtol=4e-3, atol=4e-3, msg=name)


def test_train_step_launches_every_kernel(cuda):
    """One smoke train step with remat and compression on the card: each
    kernel launches as often as the path needs, and the loss and updated
    params agree with the same step on the CPU (plain twins)."""
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import init_model
    from repro_torch.train import make_train_step, opt_init
    cfg = dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                              attn_impl="flash_pallas", remat=True,
                              optimizer="adafactor", grad_compression=True)
    gen = torch.Generator(device="cpu").manual_seed(0)
    params_cpu = init_model(gen, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           dtype=torch.int32)
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(cuda)
    params = to(params_cpu)
    step_gpu = make_train_step(cfg, device=cuda)
    state_gpu = opt_init(cfg.optimizer, params)
    counters = lambda: (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES,
                        qz.QUANT_LAUNCHES, qz.DEQUANT_LAUNCHES)
    before = counters()
    _, _, m_gpu = step_gpu(params, state_gpu, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    L = cfg.n_layers
    n_big = 9          # leaves of >= 8192 elements at this smoke size
    assert [a - b for a, b in zip(counters(), before)] == \
        [2 * L, L, L, n_big, n_big]
    state_cpu = opt_init(cfg.optimizer, params_cpu)
    _, _, m_cpu = make_train_step(cfg, device="cpu")(
        params_cpu, state_cpu, {"tokens": tokens})
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) < 1e-4
    assert abs(float(m_gpu["grad_norm"]) / float(m_cpu["grad_norm"])
               - 1) < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_the_card_matches_cpu(cuda, dtype):
    """One qwen3-moe layer's ``moe_ffn`` at smoke width, with drops (cf =
    1.0) and over 2 token groups: the card against the CPU from the same
    params and input.  fp32: summation order only (1e-5 of the largest
    |value|); bf16: the products round differently (1e-2).  The gather
    dispatch and combine have no atomics: two runs on the card are equal
    bit for bit."""
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import moe
    cfg = dataclasses.replace(smoke_variant(ARCHS["qwen3-moe-235b-a22b"]),
                              capacity_factor=1.0,
                              param_dtype=str(dtype).split(".")[1])
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = (torch.randn((4, 32, cfg.d_model),
                     generator=torch.Generator().manual_seed(1)) * 0.3) \
        .to(dtype)
    y_cpu, aux_cpu = moe.moe_ffn(params, x, cfg, n_groups=2)
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(cuda)
    y, aux = moe.moe_ffn(to(params), x.to(cuda), cfg, n_groups=2)
    y2, _ = moe.moe_ffn(to(params), x.to(cuda), cfg, n_groups=2)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = float(y_cpu.float().abs().max())
    torch.testing.assert_close(y.cpu().float(), y_cpu.float(), rtol=tol,
                               atol=tol * scale)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_serving_on_the_card_matches_cpu(cuda, arch):
    """The recurrent families' smoke prefill and one decode step in fp32
    (the hybrid's local attention through the forward kernel): hidden
    states and every cache leaf on the card against the CPU from the same
    params and tokens (summation order only, 1e-4), with one ``flash_fwd``
    a local-attention layer in the prefill and none in decode."""
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import (forward_decode, forward_prefill,
                                    init_model)
    cfg = dataclasses.replace(smoke_variant(ARCHS[arch]), n_layers=5,
                              attn_impl="flash_pallas")
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 25),
                           generator=torch.Generator().manual_seed(1))
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(cuda)
    out = {}
    for dev, p in (("cpu", params), ("cuda", to(params))):
        before = fa.LAUNCHES
        h, c = forward_prefill(p, cfg, {"tokens": tokens[:, :24].to(dev)})
        after_prefill = fa.LAUNCHES
        h2, c = forward_decode(p, cfg, c, tokens[:, 24:].to(dev), 24)
        out[dev] = (h, h2, c, after_prefill - before,
                    fa.LAUNCHES - after_prefill)
    h, h2, c, n_pre, n_dec = out["cuda"]
    want_pre = 1 if arch == "recurrentgemma-9b" else 0
    assert (n_pre, n_dec) == (want_pre, 0)
    for got, want in ((h, out["cpu"][0]), (h2, out["cpu"][1]),
                      *((c[k], out["cpu"][2][k]) for k in c)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "paligemma-3b"])
def test_encdec_and_vlm_on_the_card_match_cpu(cuda, arch):
    """The encoder-decoder's and the VLM's smoke prefill, one decode step
    and the training gradients in fp32 through the kernels, on the card
    against the CPU from the same params and inputs (summation order only,
    1e-4), with exact launch counts: one ``flash_fwd`` an encoder layer and
    two a decoder layer (self and cross) or one a VLM layer in the prefill,
    none in decode."""
    from repro_torch.configs import ARCHS, ShapeConfig, smoke_variant
    from repro_torch.models import (forward_decode, forward_prefill,
                                    init_model, make_inputs)
    from repro_torch.train import loss_and_grads
    from repro_torch.tree import tree_items
    cfg = dataclasses.replace(smoke_variant(ARCHS[arch]),
                              attn_impl="flash_pallas")
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, cfg, device="cpu")
    batch = make_inputs(gen, cfg, ShapeConfig("c", 27, 2, "prefill"),
                        device="cpu")
    pos = batch["tokens"].shape[1] + cfg.n_prefix_tokens
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(cuda)
    out = {}
    for dev, p, b in (("cpu", params, batch), ("cuda", to(params),
                                                to(batch))):
        before = fa.LAUNCHES
        h, c = forward_prefill(p, cfg, b)
        n_pre = fa.LAUNCHES - before
        h2, c = forward_decode(p, cfg, c, b["tokens"][:, -1:], pos)
        loss, _, g = loss_and_grads(p, cfg, b)
        out[dev] = (h, h2, c, loss, g, n_pre, fa.LAUNCHES - before - n_pre)
    h, h2, c, loss, g, n_pre, n_rest = out["cuda"]
    want_pre = cfg.enc_layers + 2 * cfg.dec_layers \
        if cfg.family == "encdec" else cfg.n_layers
    assert (n_pre, n_rest) == (want_pre, want_pre)   # decode 0, train fwd
    for got, want in ((h, out["cpu"][0]), (h2, out["cpu"][1]),
                      *((c[k], out["cpu"][2][k]) for k in c)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(loss.cpu(), out["cpu"][3], rtol=1e-5,
                               atol=1e-6)
    want = dict(tree_items(out["cpu"][4]))
    for path, a in tree_items(g):
        torch.testing.assert_close(a.cpu(), want[path], rtol=1e-4,
                                   atol=1e-4 * float(want[path].abs().max()),
                                   msg=path)


# ------------------------- checksum, stripe pack -------------------------

@pytest.mark.parametrize("nbytes", [1, 2, 3, 4, 5, 7, 15, 16, 17, 1001, 4096,
                                    (1 << 20) + 7, 3 * (1 << 22) + 5])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_checksum_kernel_bit_exact(cuda, nbytes, offset):
    from repro_torch.core import integrity
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(nbytes + offset)
    buf = torch.randint(0, 256, (nbytes + offset,), generator=gen,
                        device=cuda, dtype=torch.uint8)
    x = buf[offset:]
    before = ck.CHECKSUM_LAUNCHES
    got = ck.checksum(x)
    torch.cuda.synchronize()
    assert ck.CHECKSUM_LAUNCHES == before + 1
    assert torch.equal(got, ck.checksum_reference(x))
    assert ops.checksum_array(x) == integrity.checksum(x.cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8,
                                   torch.int32])
def test_checksum_kernel_leaf_dtypes(cuda, dtype):
    from repro_torch.core import integrity
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn((333, 77), generator=gen, device=cuda) * 50).to(dtype)
    assert torch.equal(ck.checksum(x), ck.checksum_reference(x))
    assert ops.checksum_array(x) == \
        integrity.checksum(ck.byte_view(x).cpu().numpy())
    count = torch.tensor(7, dtype=torch.int32, device=cuda)
    assert ops.checksum_array(count) == \
        integrity.checksum(count.cpu().numpy())


def test_checksum_kernel_refuses_unaligned_and_strided(cuda):
    from repro_torch.kernels import checksum as ck
    buf = torch.zeros(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="4-byte aligned"):
        ck.checksum(buf[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ck.checksum(torch.zeros((8, 8), device=cuda).t())


@pytest.mark.parametrize("width,cell_rows,n_mult", [(1, 1, 3), (2, 2, 1),
                                                     (4, 1, 3), (16, 128, 2),
                                                     (3, 128, 5)])
def test_shard_pack_kernels_bit_exact(cuda, width, cell_rows, n_mult):
    from repro_torch.kernels import shard_pack as sp
    gen = torch.Generator(device=cuda).manual_seed(width)
    cells = torch.randint(-2**31, 2**31 - 1, (width * n_mult, cell_rows, 128),
                          generator=gen, device=cuda, dtype=torch.int32)
    before = (sp.PACK_LAUNCHES, sp.UNPACK_LAUNCHES)
    packed = sp.shard_pack(cells, width)
    back = sp.shard_unpack(packed)
    torch.cuda.synchronize()
    assert (sp.PACK_LAUNCHES, sp.UNPACK_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(packed, sp.shard_pack_reference(cells, width))
    assert torch.equal(back, cells)


def test_ops_shard_pack_round_trip_ragged(cuda):
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((1000, 333), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    packed, meta = ops.shard_pack(x, 3, cell_bytes=4096)
    back = ops.shard_unpack(packed, meta)
    assert meta == (x.numel() * 2, 4096, 3)
    assert torch.equal(back, x.reshape(-1).view(torch.uint8))


def test_checkpoint_round_trip_on_the_card(cuda):
    """A tree on the card: checksums by the kernel on save, leaves back on
    the card and verified there on restore, bit for bit."""
    from repro_torch.ckpt import Checkpointer
    from repro_torch.core import Pool, Topology
    from repro_torch.core.interfaces import DFS
    from repro_torch.kernels import checksum as ck
    gen = torch.Generator(device=cuda).manual_seed(4)
    tree = {"w": torch.randn((64, 130), generator=gen, device=cuda)
            .to(torch.bfloat16),
            "m": torch.randn((7,), generator=gen, device=cuda),
            "count": torch.tensor(3, dtype=torch.int32, device=cuda)}
    pool = Pool(Topology(n_server_nodes=2, engines_per_node=2))
    ckp = Checkpointer(DFS(pool.create_container("g", oclass="RP_2GX")),
                       oclass="RP_2GX", n_writers=2)
    before = ck.CHECKSUM_LAUNCHES
    ev = ckp.async_save(1, tree)
    assert ck.CHECKSUM_LAUNCHES == before + 3     # on this thread, at once
    want = {k: v.clone() for k, v in tree.items()}
    tree["w"].zero_()
    ev.wait()
    back = ckp.restore(1, tree)
    assert ck.CHECKSUM_LAUNCHES == before + 6
    for k, v in want.items():
        assert back[k].device.type == "cuda" and torch.equal(back[k], v)


# ---------------------------- decode attention ----------------------------

# (B, S_cache, Hq, n_kv, D, rotary_pct, rope_theta, pos): every family's
# full-width decode shape (the serving slice's 4 rows, prompts of 1024 and
# 32 slots to spare; recurrentgemma's ring of 2048 past its wrap), chat's
# (16 x 1152 at the first and last traced positions), and small ones.
DECODE_CASES = [
    (4, 1056, 32, 32, 128, 1.0, 1e4, 1024),   # deepseek-7b
    (16, 1152, 32, 32, 128, 1.0, 1e4, 1024),  # chat, first traced step
    (16, 1152, 32, 32, 128, 1.0, 1e4, 1055),  # chat, last traced step
    (4, 1056, 32, 2, 128, 0.5, 1e4, 1040),    # chatglm3: G 16, rotary 0.5
    (4, 1056, 32, 32, 80, 0.25, 1e4, 1030),   # stablelm: D 80, rotary 0.25
    (4, 1056, 32, 8, 80, 1.0, 1e4, 1050),     # h2o-danube: D 80, G 4
    (4, 1056, 64, 4, 128, 1.0, 1e6, 1055),    # qwen3-moe: G 16
    (4, 1056, 56, 8, 128, 1.0, 1e4, 1025),    # arctic: G 7
    (4, 1312, 8, 1, 256, 1.0, 1e4, 1280),     # paligemma: MQA G 8, D 256
    (4, 2048, 16, 1, 256, 1.0, 1e4, 2100),    # recurrentgemma: wrapped ring
    (4, 544, 16, 16, 64, 0.0, 1e4, 512),      # seamless decoder: no rotary
    (2, 10, 4, 2, 16, 1.0, 1e4, 3),           # smoke: D 16
    (2, 10, 4, 2, 16, 0.5, 1e4, 25),          # smoke, wrapped
    (3, 300, 12, 4, 64, 1.0, 1e4, 0),         # the first position, G 3
    (1, 5000, 8, 1, 128, 1.0, 1e4, 4999),     # many splits, G 8
]


def _decode_inputs(case, dtype, device):
    B, S, Hq, n_kv, D = case[:5]
    gen = torch.Generator(device=device).manual_seed(S * D + Hq)
    mk = lambda *s: torch.randn(s, generator=gen, device=device).to(dtype)
    return (mk(B, 1, Hq, D), mk(B, 1, n_kv, D), mk(B, 1, n_kv, D),
            mk(B, S, n_kv, D), mk(B, S, n_kv, D))


def _ulps(a, b):
    """Units in the last place between two same-dtype tensors of one sign."""
    it = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return (a.view(it).long() - b.view(it).long()).abs()


@pytest.mark.parametrize("rope_bf16", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attn_kernel_matches_plain_version(cuda, case, dtype,
                                                  rope_bf16):
    """The output within the flash forward's tolerance of the twin run on
    the card in the same dtype; the v slot bit-equal, the k slot within one
    ulp (rope's cos/sin); every other slot untouched; one launch on the
    route the shape takes."""
    from repro_torch.kernels import decode_attention as da
    B, S, Hq, n_kv, D, pct, theta, pos = case
    q, k, v, ck, cv = _decode_inputs(case, dtype, cuda)
    ck0, cv0 = ck.clone(), cv.clone()
    rk, rv = ck.clone(), cv.clone()
    route = da._route(dtype, Hq // n_kv)
    before, routes = da.DECODE_ATTN_LAUNCHES, dict(da.ROUTE_LAUNCHES)
    out = da.decode_attn(q, k, v, ck, cv, pos, pct, theta, rope_bf16)
    torch.cuda.synchronize()
    assert da.DECODE_ATTN_LAUNCHES == before + 1
    assert {r: da.ROUTE_LAUNCHES[r] - routes[r] for r in routes} \
        == {r: int(r == route) for r in routes}
    want = da.decode_attention_reference(q, k, v, rk, rv, pos, pct, theta,
                                         rope_bf16)
    assert out.shape == want.shape and out.dtype == dtype
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    slot = pos % S
    assert torch.equal(cv[:, slot], rv[:, slot])
    assert int(_ulps(ck[:, slot], rk[:, slot]).max()) <= 1
    keep = torch.ones(S, dtype=torch.bool, device=cuda)
    keep[slot] = False
    assert torch.equal(ck[:, keep], ck0[:, keep])
    assert torch.equal(cv[:, keep], cv0[:, keep])


@pytest.mark.parametrize("pos", [1024, 1151])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_takes_a_set_scale(cuda, dtype, pos):
    """granite-4.0-h-small's shape: 16 rows, 32 q / 8 kv heads of 128, no
    rope, softmax scale 1/128 over 1152 slots (G 4, the CUDA-core route):
    the kernel against its twin at that scale, and the scale taken (the
    default 1/sqrt(128) gives another output)."""
    from repro_torch.kernels import decode_attention as da
    case = (16, 1152, 32, 8, 128, 0.0, 1e4, pos)
    q, k, v, ck, cv = _decode_inputs(case, dtype, cuda)
    rk, rv = ck.clone(), cv.clone()
    routes = dict(da.ROUTE_LAUNCHES)
    out = da.decode_attn(q, k, v, ck, cv, pos, 0.0, 1e4, False, 1 / 128)
    torch.cuda.synchronize()
    assert da.ROUTE_LAUNCHES["simt"] == routes["simt"] + 1
    want = da.decode_attention_reference(q, k, v, rk, rv, pos, 0.0, 1e4,
                                         False, 1 / 128)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(ck[:, pos], k[:, 0]) and torch.equal(cv[:, pos],
                                                            v[:, 0])
    default = da.decode_attention_reference(q, k, v, rk, rv, pos, 0.0, 1e4,
                                            False)
    assert float((default.float() - want.float()).abs().max()) > 10 * tol


def test_granite_decode_graphs_replay_the_eager_step(cuda):
    """granite-4.0-h-small's smoke model in bf16 on the card: decode steps
    replayed from CUDA graphs (``DecodeGraphs``, captured after the first
    step on the cache, which runs op by op) give the bits of the op-by-op
    step, logits and cache, step after step, and its spans and call
    counters."""

    import contextlib

    from repro_torch import spans
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import forward_decode, init_model
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import ssm as SSM
    from repro_torch.serve import make_decode_step, make_prefill_step
    cfg = dataclasses.replace(smoke_variant(ARCHS["granite-4.0-h-small"]),
                              param_dtype="bfloat16", attn_impl="flash")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_model(gen, cfg, device=cuda)
    toks = torch.randint(0, 256, (4, 12), generator=gen, device=cuda,
                         dtype=torch.int32)
    _, cache_g = make_prefill_step(cfg, pad_to=20, device=cuda)(
        params, {"tokens": toks[:, :8]})
    cache_e = {k: v.clone() for k, v in cache_g.items()}
    graphed = make_decode_step(cfg, device=cuda)
    captures = D.GRAPH_CAPTURES
    for pos in range(8, 12):
        tok = toks[:, pos:pos + 1]
        SSM.SSD_CALLS.update(prefill=0, decode=0)
        M.DROPLESS_CALLS.update(batched=0, grouped=0)
        spans.reset()
        # the first step captures: under a profiler its capture would
        # enter the spans a second time
        ctx = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) if pos > 8 \
            else contextlib.nullcontext()
        with ctx:
            _, lg_g, cache_g = graphed(params, cache_g, tok, pos)
        rec = spans.record()
        assert (SSM.SSD_CALLS["decode"], M.DROPLESS_CALLS["batched"]) \
            == (2, 3)
        if pos > 8:
            assert (rec["decode.ssm"]["count"],
                    rec["decode.moe"]["count"]) == (2, 3)
        assert D.GRAPH_CAPTURES == captures + 1
        with torch.no_grad():
            h, cache_e = forward_decode(params, cfg, cache_e, tok, pos)
            lg_e = L.lm_logits(params["embed"], h, cfg)
        assert torch.equal(lg_g, lg_e)
        for k in cache_e:
            assert torch.equal(cache_g[k], cache_e[k]), k
    spans.reset()


def test_decode_attn_is_bit_equal_on_a_repeat(cuda):
    """No atomics: the same inputs give the same bits, split or not."""
    from repro_torch.kernels import decode_attention as da
    for case in ((4, 2048, 16, 1, 256, 1.0, 1e4, 2100),
                 (16, 1152, 32, 32, 128, 1.0, 1e4, 1055)):
        q, k, v, ck, cv = _decode_inputs(case, torch.bfloat16, cuda)
        a = da.decode_attn(q, k, v, ck, cv, case[-1], case[5], case[6],
                           False)
        b = da.decode_attn(q, k, v, ck, cv, case[-1], case[5], case[6],
                           False)
        assert torch.equal(a, b)


def test_decode_attn_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels import decode_attention as da
    q, k, v, ck, cv = _decode_inputs((2, 64, 4, 2, 128, 1.0, 1e4, 5),
                                     torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attn(q[..., ::2], k[..., ::2], v[..., ::2], ck[..., ::2],
                       cv[..., ::2], 5, 1.0, 1e4, False)
    q2, k2, v2, ck2, cv2 = _decode_inputs((2, 64, 34, 2, 128, 1.0, 1e4, 5),
                                          torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="groups"):
        da.decode_attn(q2, k2, v2, ck2, cv2, 5, 1.0, 1e4, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_decode_on_the_card_launches_the_kernel(cuda, dtype):
    """deepseek-7b's smoke prefill and 3 decode steps on the card against
    the CPU from the same params and tokens (fp32: summation order, 1e-4;
    bf16, where the two devices' matrix products round apart: 2e-2 of the
    norm, chip_smoke.py's HIDDEN_REL_TOL), with exactly one
    ``decode_attn`` a layer a step."""
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import (forward_decode, forward_prefill,
                                    init_model)
    cfg = dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                              attn_impl="flash_pallas", param_dtype=dtype)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 27),
                           generator=torch.Generator().manual_seed(1))
    to = lambda t: {k: to(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(cuda)
    out = {}
    for dev, p in (("cpu", params), ("cuda", to(params))):
        with torch.no_grad():
            _, c = forward_prefill(p, cfg, {"tokens": tokens[:, :24].to(dev)},
                                   pad_to=28)
            before = da.DECODE_ATTN_LAUNCHES
            hs = []
            for t in range(3):
                h, c = forward_decode(p, cfg, c, tokens[:, 24 + t:25 + t]
                                      .to(dev), 24 + t)
                hs.append(h)
        out[dev] = (hs, c, da.DECODE_ATTN_LAUNCHES - before)
    hs, c, n = out["cuda"]
    assert out["cpu"][2] == 0 and n == 3 * cfg.n_layers
    for got, want in ((torch.stack(hs), torch.stack(out["cpu"][0])),
                      *((c[k], out["cpu"][1][k]) for k in c)):
        got, want = got.cpu().float(), want.float()
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert float((got - want).norm() / want.norm()) <= 2e-2


def test_traced_decode_attention_copies_and_waits_for_nothing(cuda):
    """Under the profiler, inside every ``repro_torch.decode.attention``
    span of a decode step: launches, but no host-to-device copy and no
    synchronisation."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import (forward_decode, forward_prefill,
                                    init_model)
    cfg = dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                              attn_impl="flash_pallas",
                              param_dtype="bfloat16")
    params = init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                        device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), device=cuda)
    with torch.no_grad():
        _, c = forward_prefill(params, cfg, {"tokens": tokens[:, :16]},
                               pad_to=20)
        forward_decode(params, cfg, c, tokens[:, 16:], 16)   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward_decode(params, cfg, c, tokens[:, 16:], 17)
            torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "repro_torch.decode.attention"]
    assert len(spans) == cfg.n_layers
    inside = lambda e: any(s <= e.time_range.start and e.time_range.end <= t
                           for s, t in spans)
    names = [e.name for e in events if inside(e)]
    assert any("LaunchKernel" in n for n in names), sorted(set(names))
    bad = [n for n in names if "Memcpy" in n or "Synchronize" in n
           or "memcpy" in n]
    assert bad == [], bad

"""The port's CUDA kernels on the card, against their plain torch versions:
flash attention forward and backward, int8 quantize / dequantize, and the
kernel paths of prefill and of a training step.

These need an NVIDIA card and ``nvcc`` (the kernels are built at first use)
and skip elsewhere.  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py``.
"""
import dataclasses

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
]
# Cross-attention, bidirectional with Sq != Sk: (B, Sq, Sk, Hq, n_kv, D).
# seamless's decode identity (513 decoder queries over 512 encoder keys),
# ragged lengths either way, and D = 256 with G = 8.
CROSS_CASES = [
    (4, 513, 512, 16, 16, 64),
    (2, 2048, 1000, 16, 16, 64),
    (2, 200, 333, 4, 2, 128),
    (1, 77, 300, 8, 1, 256),
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
    before = fa.LAUNCHES
    out, lse = fa.flash_fwd(q5, k4, v4, causal=causal, window=window,
                            prefix=prefix)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
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
    before = fa.LAUNCHES
    out, lse = fa.flash_fwd(q5, k4, v4, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref_out, ref_lse = fa.flash_fwd_reference(q5.float(), k4.float(),
                                              v4.float(), causal=True)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
    _assert_row_blocks_close(out, ref_out, torch.bfloat16, "out")


def test_flash_fwd_bf16_kernel_takes_a_negative_scale(cuda):
    """A negative scale runs the tensor-core kernel on a negated q tile
    with |scale|: held against the plain version at the bf16 limits,
    causal and windowed, at D == 128 (no column guards) and D = 80."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for B, S, H, D, window in [(2, 200, 4, 128, 0), (1, 300, 2, 80, 64)]:
        q, k, v = (torch.randn(shape, device=cuda, generator=g)
                   .to(torch.bfloat16)
                   for shape in [(B, H, 2, S, D), (B, H, S, D),
                                 (B, H, S, D)])
        scale = -1.0 / D ** 0.5
        before = fa.LAUNCHES
        out, lse = fa.flash_fwd(q, k, v, causal=True, window=window,
                                scale=scale)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before + 1
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
    got = fa.flash_bwd(*args, **mask)
    torch.cuda.synchronize()
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
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
    got = fa.flash_bwd(q5, k4, v4, do5, lse, delta, **mask)
    want = fa.flash_bwd_reference(q5.float(), k4.float(), v4.float(),
                                  do5.float(), lse, delta, **mask)
    rtol, atol = GRAD_TOL[dtype]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        scale = 1.0 if dtype == torch.float32 else float(w.abs().max())
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=atol * scale, msg=name)
        _assert_row_blocks_close(g, w, dtype, name)


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

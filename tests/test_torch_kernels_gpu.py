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
]
# fp32: the reference tests' 3e-4.  bf16: fp32 inside, `out` rounded once
# to bf16 (2^-8 relative).
TOL = {torch.float32: 3e-4, torch.bfloat16: 1e-2}
# Gradients.  fp32: the reference tests' 4e-3.  bf16: fp32 inside, each of
# dq/dk/dv rounded once to bf16 (2^-8 relative), held at 1e-2 relative
# plus 1e-2 of the largest |gradient| (sums over thousands of keys cancel).
GRAD_TOL = {torch.float32: (4e-3, 4e-3), torch.bfloat16: (1e-2, 1e-2)}
# The elementwise limits are loose for the late rows of a causal pass,
# whose values are far below the first rows'.  So out, dq, dk and dv are
# also held in 8 blocks of rows (dim -2): each block's norm of the
# difference over the plain version's norm (one bf16 rounding gives about
# 1.1e-3; fp32 differs only in summation order).
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

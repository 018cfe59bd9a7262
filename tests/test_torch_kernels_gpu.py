"""The port's CUDA kernels on the card, against their plain torch versions.

These need an NVIDIA card and ``nvcc`` (the kernels are built at first use)
and skip elsewhere.  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import flash_attention as fa

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
]
# fp32: the reference tests' 3e-4.  bf16: fp32 inside, `out` rounded once
# to bf16 (2^-8 relative).
TOL = {torch.float32: 3e-4, torch.bfloat16: 1e-2}


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

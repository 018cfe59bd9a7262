"""The flash-attention backward's routing, decided on the CPU from the
inputs alone: ``_bwd_route`` sends bf16 inputs with D in {64, 128, 256} and
16-byte aligned pointers and strides to the wgmma kernels, other bf16
inputs to the mma.sync kernels and fp32 to the fp32 kernels; and
``_dkv_chunks``, the wgmma dk/dv pass's split of the G query groups over
blocks.  The tensors lie on the meta device (shapes and strides, no bytes),
laid out as ``ops.flash_attention`` and the card tests lay them out."""
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa

# tests/test_torch_kernels_gpu.py's cases and the route each takes in bf16
GPU_CASES = [
    # B, S, Hq, n_kv, D, causal, window, prefix; route
    ((2, 64, 4, 2, 128, True, 0, 0), "wgmma"),
    ((2, 64, 4, 2, 80, True, 0, 0), "mma"),
    ((2, 96, 4, 1, 128, True, 32, 0), "wgmma"),
    ((2, 64, 4, 4, 128, True, 0, 16), "wgmma"),
    ((1, 64, 4, 4, 128, False, 0, 0), "wgmma"),
    ((1, 333, 6, 3, 256, True, 100, 0), "wgmma"),
    ((1, 130, 2, 2, 40, True, 0, 70), "mma"),
    ((2, 4096, 32, 32, 128, True, 0, 0), "wgmma"),
    ((2, 200, 8, 2, 128, True, 0, 0), "wgmma"),
    ((8, 256, 16, 16, 64, True, 0, 0), "wgmma"),
    ((1, 70, 4, 2, 36, True, 0, 0), "mma"),
    ((1, 257, 4, 2, 256, False, 64, 0), "wgmma"),
    ((1, 300, 4, 1, 96, True, 50, 20), "mma"),
    ((4, 1024, 64, 4, 128, True, 0, 0), "wgmma"),
    ((2, 4096, 64, 4, 128, True, 0, 0), "wgmma"),
    ((4, 1024, 16, 1, 256, True, 2048, 0), "wgmma"),
    ((2, 4096, 16, 1, 256, True, 2048, 0), "wgmma"),
    ((4, 512, 16, 16, 64, True, 0, 0), "wgmma"),
    ((4, 512, 16, 16, 64, False, 0, 0), "wgmma"),
    ((2, 2048, 16, 16, 64, True, 0, 0), "wgmma"),
    ((4, 1024, 8, 1, 256, True, 0, 256), "wgmma"),
    ((2, 4096, 8, 1, 256, True, 0, 256), "wgmma"),
]
# each family's training slice in chip_smoke.py: (arch, B, S)
TRAIN_SHAPES = [("deepseek-7b", 2, 4096), ("qwen3-moe-235b-a22b", 2, 4096),
                ("recurrentgemma-9b", 2, 4096),
                ("seamless-m4t-large-v2", 2, 2048), ("paligemma-3b", 2, 4096)]


def _inputs(B, S, Hq, n_kv, D, dtype=torch.bfloat16, Sk=None):
    """q, k, v, dO in the model's (B, S, H, D) layout as the kernel's 5-D
    and 4-D views, and lse and delta, on the meta device."""
    Sk = S if Sk is None else Sk
    mk = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    five = lambda x: x.reshape(B, S, n_kv, Hq // n_kv, D) \
        .permute(0, 2, 3, 1, 4)
    q5, do5 = five(mk(B, S, Hq, D)), five(mk(B, S, Hq, D))
    k4 = mk(B, Sk, n_kv, D).permute(0, 2, 1, 3)
    v4 = mk(B, Sk, n_kv, D).permute(0, 2, 1, 3)
    rows = mk(B, n_kv, Hq // n_kv, S, dt=torch.float32)
    return q5, k4, v4, do5, rows, rows


def route_of(q5, k4, v4, do5, lse, delta):
    """The route ``flash_bwd`` takes for these inputs, from the same
    pointers and strides it passes."""
    strides = (*q5.stride()[:4], *k4.stride()[:3], *v4.stride()[:3],
               *do5.stride()[:4])
    ptrs = [t.data_ptr() for t in (q5, k4, v4, do5, lse, delta)]
    return fa._bwd_route(q5.dtype, tuple(q5.shape), ptrs, strides)


@pytest.mark.parametrize("case,route", GPU_CASES)
def test_gpu_cases_take_their_route(case, route):
    B, S, Hq, n_kv, D = case[:5]
    assert route_of(*_inputs(B, S, Hq, n_kv, D)) == route
    assert route_of(*_inputs(B, S, Hq, n_kv, D, torch.float32)) == "fp32"


@pytest.mark.parametrize("case", [(4, 513, 512, 16, 16, 64),
                                  (2, 2048, 1000, 16, 16, 64),
                                  (2, 200, 333, 4, 2, 128),
                                  (1, 77, 300, 8, 1, 256)])
def test_cross_cases_take_the_wgmma_route(case):
    """Sq != Sk (the gpu tests' cross cases): the shape of k decides
    nothing, D and the alignment do."""
    B, Sq, Sk, Hq, n_kv, D = case
    assert route_of(*_inputs(B, Sq, Hq, n_kv, D, Sk=Sk)) == "wgmma"


@pytest.mark.parametrize("arch,B,S", TRAIN_SHAPES)
def test_every_family_training_shape_takes_the_wgmma_route(arch, B, S):
    cfg = get_arch(arch)
    assert route_of(*_inputs(B, S, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim)) == "wgmma"


@pytest.mark.parametrize("which", ["q", "k", "v", "do", "lse"])
def test_a_view_off_16_bytes_takes_the_mma_route(which):
    """One operand 2 bytes (lse: 4) past a 16-byte boundary: TMA cannot
    read it, so the mma.sync kernels, which take 2-byte loads, do."""
    B, S, Hq, n_kv, D = 2, 200, 8, 2, 128
    q5, k4, v4, do5, lse, delta = _inputs(B, S, Hq, n_kv, D)
    ts = dict(q=q5, k=k4, v=v4, do=do5, lse=lse)
    t = ts[which]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="meta")[1:]
    ts[which] = buf.view(t.shape) if which == "lse" else \
        buf.as_strided(t.shape, t.stride())
    assert ts[which].data_ptr() % 16 != 0
    assert route_of(ts["q"], ts["k"], ts["v"], ts["do"], ts["lse"],
                    delta) == "mma"


def test_a_row_pitch_off_16_bytes_takes_the_mma_route():
    """k and v rows 132 values apart (a wider buffer's first 128 columns):
    aligned pointers, strides that TMA cannot take."""
    B, S, Hq, n_kv, D = 2, 200, 8, 2, 128
    q5, _, _, do5, lse, delta = _inputs(B, S, Hq, n_kv, D)
    wide = torch.empty((B, S, n_kv, D + 4), dtype=torch.bfloat16,
                       device="meta")[..., :D].permute(0, 2, 1, 3)
    assert route_of(q5, wide, wide, do5, lse, delta) == "mma"


@pytest.mark.parametrize("shape,chunks", [
    ((2, 32, 1, 4096, 128), 1),     # deepseek: G = 1, 2048 blocks
    ((2, 4, 16, 4096, 128), 3),     # qwen3-moe training: 256 blocks
    ((4, 4, 16, 1024, 128), 5),     # qwen3-moe serving shape: 128
    ((2, 1, 16, 4096, 256), 5),     # recurrentgemma: 128 blocks of 64 rows
    ((2, 1, 8, 4096, 256), 5),      # paligemma
    ((4, 1, 8, 1024, 256), 8),      # paligemma serving shape: at most G
    ((2, 16, 1, 2048, 64), 1),      # seamless
])
def test_dkv_chunks_rule(shape, chunks):
    """Chunks = the fewest that give 4 blocks an SM of 132, at most G."""
    B, H, G, Sk, D = shape
    assert fa._dkv_chunks(B, H, G, Sk, D) == chunks


@pytest.mark.parametrize("G,chunks", [(16, 3), (16, 5), (8, 3), (8, 5),
                                      (2, 2), (16, 16), (1, 1)])
def test_dkv_chunks_cover_every_group_once(G, chunks):
    """Chunk c takes groups [c G / n, (c + 1) G / n): none empty, none
    shared, all G covered in order."""
    bounds = [c * G // chunks for c in range(chunks + 1)]
    assert bounds[0] == 0 and bounds[-1] == G
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))


def test_fp32_never_takes_a_bf16_route():
    q5, k4, v4, do5, lse, delta = _inputs(1, 64, 2, 1, 128, torch.float32)
    assert route_of(q5, k4, v4, do5, lse, delta) == "fp32"

"""The flash-attention forward's routing, decided on the CPU from the inputs
alone: ``_fwd_route`` sends bf16 inputs with D in {64, 128, 256} and
16-byte aligned pointers and strides (q, k, v and the wrapper's out) to the
wgmma kernel, other bf16 inputs to the mma.sync kernel and fp32 to the
fp32 kernel.  The tensors lie on the meta device (shapes and strides, no
bytes), laid out as ``ops.flash_attention`` lays them out and ``out`` as
the wrapper allocates it.  The wrapper's own choice is read by driving its
card branch on meta tensors with the launch seam's device entry replaced
by a recorder (``test_torch_launch_seam.record_launches``): that shows the
route code it passes and the counter it moves, and that the scale's sign
plays no part."""
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from test_torch_kernels_gpu import CASES, CROSS_CASES, WG_FWD_CASES
from test_torch_launch_seam import record_launches

# each family's serving and training shape in chip_smoke.py: (arch, B, Sq,
# Sk); seamless serves 512 frames and 512 tokens, and its decode identity
# runs the cross-attention at 513 queries over 512 keys
FAMILY_SHAPES = [
    ("deepseek-7b", 4, 1024, 1024), ("deepseek-7b", 2, 4096, 4096),
    ("qwen3-moe-235b-a22b", 4, 1024, 1024),
    ("qwen3-moe-235b-a22b", 2, 4096, 4096),
    ("recurrentgemma-9b", 4, 1024, 1024), ("recurrentgemma-9b", 2, 4096, 4096),
    ("seamless-m4t-large-v2", 4, 512, 512),
    ("seamless-m4t-large-v2", 4, 513, 512),
    ("seamless-m4t-large-v2", 2, 2048, 2048),
    ("paligemma-3b", 4, 1024, 1024), ("paligemma-3b", 2, 4096, 4096),
]


def _inputs(B, S, Hq, n_kv, D, dtype=torch.bfloat16, Sk=None):
    """q, k, v in the model's (B, S, H, D) layout as the kernel's 5-D and
    4-D views, on the meta device."""
    Sk = S if Sk is None else Sk
    mk = lambda *shape: torch.empty(shape, dtype=dtype, device="meta")
    q5 = mk(B, S, Hq, D).reshape(B, S, n_kv, Hq // n_kv, D) \
        .permute(0, 2, 3, 1, 4)
    k4 = mk(B, Sk, n_kv, D).permute(0, 2, 1, 3)
    v4 = mk(B, Sk, n_kv, D).permute(0, 2, 1, 3)
    return q5, k4, v4


def route_of(q5, k4, v4):
    """The route ``flash_fwd`` takes for these inputs, from the pointers
    and strides it passes (``out`` laid out as the wrapper allocates it)."""
    B, H, G, S, D = q5.shape
    out = torch.empty((B, S, H, G, D), dtype=q5.dtype,
                      device="meta").permute(0, 2, 3, 1, 4)
    strides = (*q5.stride()[:4], *k4.stride()[:3], *v4.stride()[:3],
               *out.stride()[:4])
    ptrs = [t.data_ptr() for t in (q5, k4, v4, out)]
    return fa._fwd_route(q5.dtype, tuple(q5.shape), ptrs, strides)


def _case_route(case):
    return route_of(*_inputs(*case[:5], Sk=case[8] if len(case) > 8
                             else None))


@pytest.mark.parametrize("case", CASES + WG_FWD_CASES)
def test_gpu_forward_cases_take_their_route(case):
    """Every forward case of the card tests (``CASES`` holds the backward
    route tests' ``GPU_CASES``): wgmma where D is 64, 128 or 256 (their
    views are aligned), else mma; fp32 always fp32."""
    want = "wgmma" if case[4] in fa.WG_HEAD_DIMS else "mma"
    assert _case_route(case) == want
    assert route_of(*_inputs(*case[:5], dtype=torch.float32)) == "fp32"


@pytest.mark.parametrize("case", CROSS_CASES)
def test_cross_cases_take_the_wgmma_route(case):
    """Sq != Sk: the length of k decides nothing, D and the alignment do."""
    B, Sq, Sk, Hq, n_kv, D = case
    assert route_of(*_inputs(B, Sq, Hq, n_kv, D, Sk=Sk)) == "wgmma"


@pytest.mark.parametrize("arch,B,Sq,Sk", FAMILY_SHAPES)
def test_every_family_shape_takes_the_wgmma_route(arch, B, Sq, Sk):
    cfg = get_arch(arch)
    assert route_of(*_inputs(B, Sq, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, Sk=Sk)) == "wgmma"


@pytest.mark.parametrize("D", [80, 40, 36, 96])
def test_other_head_dims_take_the_mma_route(D):
    assert route_of(*_inputs(2, 200, 8, 2, D)) == "mma"


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_a_view_off_16_bytes_takes_the_mma_route(which):
    """One operand 2 bytes past a 16-byte boundary: TMA cannot read it, so
    the mma.sync kernel, which takes 2-byte loads, does."""
    ts = dict(zip("qkv", _inputs(2, 200, 8, 2, 128)))
    t = ts[which]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="meta")[1:]
    ts[which] = buf.as_strided(t.shape, t.stride())
    assert ts[which].data_ptr() % 16 != 0
    assert route_of(ts["q"], ts["k"], ts["v"]) == "mma"


def test_a_row_pitch_off_16_bytes_takes_the_mma_route():
    """k and v rows 132 values apart (a wider buffer's first 128 columns):
    aligned pointers, strides that TMA cannot take."""
    B, S, n_kv, D = 2, 200, 2, 128
    q5, _, _ = _inputs(B, S, 8, n_kv, D)
    wide = torch.empty((B, S, n_kv, D + 4), dtype=torch.bfloat16,
                       device="meta")[..., :D].permute(0, 2, 1, 3)
    assert route_of(q5, wide, wide) == "mma"


def test_fp32_never_takes_a_bf16_route():
    assert route_of(*_inputs(1, 64, 2, 1, 128, torch.float32)) == "fp32"


@pytest.fixture
def recorded(monkeypatch):
    """``flash_fwd``'s card branch on meta tensors: the route code of each
    launch (its argument after the dtype's); the counters start at 0."""
    log, _ = record_launches(monkeypatch)
    monkeypatch.setattr(fa, "LAUNCHES", 0)
    monkeypatch.setattr(fa, "FWD_ROUTE_LAUNCHES",
                        {"wgmma": 0, "mma": 0, "fp32": 0})
    return log


@pytest.mark.parametrize("D,route", [(128, "wgmma"), (256, "wgmma"),
                                     (64, "wgmma"), (80, "mma")])
def test_a_negative_scale_takes_the_same_route(recorded, D, route):
    """The wrapper passes the route it chose and counts it; a negative
    scale changes neither (the kernels run it on a negated q tile)."""
    q5, k4, v4 = _inputs(2, 200, 8, 2, D)
    for scale in (1.0 / D ** 0.5, -1.0 / D ** 0.5):
        fa.flash_fwd(q5, k4, v4, causal=True, scale=scale)
    assert [args[8] for _, _, args in recorded] \
        == [fa._ROUTE_CODES[route]] * 2
    assert fa.LAUNCHES == 2
    assert fa.FWD_ROUTE_LAUNCHES == {r: 2 if r == route else 0
                                     for r in ("wgmma", "mma", "fp32")}


def test_a_cpu_call_counts_no_launch():
    """On the CPU the wrapper computes the twin: no kernel, no route."""
    g = torch.Generator().manual_seed(0)
    q5 = torch.randn((1, 2, 2, 16, 64), generator=g).to(torch.bfloat16)
    k4 = torch.randn((1, 2, 16, 64), generator=g).to(torch.bfloat16)
    launches, routes = fa.LAUNCHES, dict(fa.FWD_ROUTE_LAUNCHES)
    out, lse = fa.flash_fwd(q5, k4, k4, causal=True)
    assert out.shape == q5.shape and lse.shape == q5.shape[:4]
    assert fa.LAUNCHES == launches
    assert fa.FWD_ROUTE_LAUNCHES == routes

"""The port's op-level cost counter (``launch/op_cost.py``) held against the
JAX package's HLO cost analysis, and the kernels as units of cost.

* FLOPs: ``OpCost`` around the port's prefill and train steps, run on the
  meta device, against ``repro.launch.hlo_cost.analyze`` of the compiled
  JAX step, at the smoke size of every family, both with
  ``attn_impl="flash"`` (the blockwise twin, whose products both counters
  see).  They are equal, except for mamba2's train step (see
  ``test_ssd_backward_reductions_are_dots_in_jax_only``).
* The kernels' custom ops: their fakes make the twins' output shapes and
  dtypes; their FLOP formulas count the (query, key) pairs the mask lets
  through, as a hand count does; on the CPU the op is counted by its
  formula and never by the twin's own ops inside it.
* Bytes and peak live bytes against an allocation sequence reckoned by
  hand."""
import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.configs.base import ShapeConfig as JaxShape
from repro.launch.hlo_cost import analyze
from repro.models import input_specs as jax_input_specs
from repro.models import param_shapes as jax_param_shapes
from repro.serve import make_prefill_step as jax_prefill_step
from repro.train import make_train_step as jax_train_step
from repro.train import opt_state_shapes as jax_opt_state_shapes
from repro_torch.configs import ARCHS, ShapeConfig, smoke_variant
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import input_specs, param_shapes
from repro_torch.serve import make_prefill_step
from repro_torch.train import make_train_step, opt_state_shapes

FAMILIES = ["deepseek-7b", "qwen3-moe-235b-a22b", "mamba2-370m",
            "recurrentgemma-9b", "seamless-m4t-large-v2", "paligemma-3b"]
B, S = 2, 16
MASKS = [dict(causal=True, window=0, prefix=0),
         dict(causal=False, window=0, prefix=0),
         dict(causal=True, window=5, prefix=0),
         dict(causal=True, window=0, prefix=6),
         dict(causal=True, window=4, prefix=3),
         dict(causal=False, window=3, prefix=0)]


def _meta(spec):
    if isinstance(spec, dict):
        return {k: _meta(v) for k, v in spec.items()}
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _jax_flops(arch, kind) -> float:
    cfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), attn_impl="flash")
    params = jax_param_shapes(cfg)
    batch = jax_input_specs(cfg, JaxShape("x", S, B, kind))
    if kind == "train":
        step = jax_train_step(cfg, n_groups=1)
        args = (params, jax_opt_state_shapes(cfg.optimizer, params), batch)
    else:
        step, args = jax_prefill_step(cfg), (params, batch)
    return analyze(jax.jit(step).lower(*args).compile().as_text())["flops"]


def _port_cost(arch, kind, impl="flash") -> OpCost:
    cfg = dataclasses.replace(smoke_variant(ARCHS[arch]), attn_impl=impl)
    params = param_shapes(cfg)
    batch = _meta(input_specs(cfg, ShapeConfig("x", S, B, kind)))
    if kind == "train":
        step = make_train_step(cfg, device="meta")
        args = (params, opt_state_shapes(cfg.optimizer, params), batch)
    else:
        step, args = make_prefill_step(cfg, device="meta"), (params, batch)
    with OpCost() as cost:
        step(*args)
    return cost


# mamba2's train step is held by test_ssd_backward_reductions_are_dots_
# in_jax_only
@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in FAMILIES for k in ("prefill", "train")
    if (a, k) != ("mamba2-370m", "train")])
def test_step_flops_equal_hlo_cost(arch, kind):
    assert _port_cost(arch, kind).flops == _jax_flops(arch, kind)


def test_ssd_backward_reductions_are_dots_in_jax_only():
    """mamba2's train step: the SSD's three-operand einsums
    ("bcqn,bcqh,bcqhp->bchnp", "bcqn,bcqh,bchnp->bcqhp") scale by the
    per-(b, c, q, h) decay factors.  The port multiplies those factors in
    elementwise; jnp.einsum contracts them pairwise, and in the backward
    XLA writes the factors' gradients (a sum over P of products) as
    dot_generals, which hlo_cost counts and the FLOP registry, seeing a
    multiply and a sum, does not.  The arithmetic is the same; at the smoke
    shape (N = P = 16) JAX's einsum path makes three such reductions a
    layer, 2 B S H P FLOPs each.  Which ones XLA emits follows
    opt_einsum's path, which changes with N and P."""
    cfg = smoke_variant(ARCHS["mamba2-370m"])
    H, P, L = cfg.ssm_heads, cfg.ssm_headdim, cfg.n_layers
    assert cfg.ssm_state == P
    reductions = 3 * L * 2 * B * S * H * P
    assert _jax_flops("mamba2-370m", "train") \
        - _port_cost("mamba2-370m", "train").flops == reductions
    assert _port_cost("mamba2-370m", "prefill").flops \
        == _jax_flops("mamba2-370m", "prefill")


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("S_q,S_k", [(9, 9), (7, 12), (12, 7), (1, 10)])
def test_allowed_pairs_equals_a_hand_count(S_q, S_k, mask):
    allow = fa._allow(S_q, S_k, device="cpu", **mask)
    assert fa.allowed_pairs(S_q, S_k, **mask) == int(allow.sum())


def _qkv(S_q=10, S_k=10, n_kv=2, G=3, D=8, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S_q, n_kv * G, D),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S_k, n_kv, D),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S_k, n_kv, D),
                                             dtype=np.float32))
    return q, k, v


@pytest.mark.parametrize("mask", MASKS)
def test_kernel_op_is_counted_by_its_formula_once(mask):
    """On the CPU the custom op runs the twin, whose einsums would count
    too if the counter saw them; it sees the op only, so forward plus
    backward is the formula's 2 + 7 products of 2 B Hq D a pair, and
    nothing else."""
    q, k, v = (t.requires_grad_() for t in _qkv())
    pairs = int(fa._allow(10, 10, device="cpu", **mask).sum())
    per_product = 2 * B * 6 * 8 * pairs
    with OpCost() as cost:
        out = ops.flash_attention(q, k, v, 2, **mask)
        out.sum().backward()
    assert cost.by_op["repro_torch.flash_fwd"]["flops"] == 2 * per_product
    assert cost.by_op["repro_torch.flash_bwd"]["flops"] == 7 * per_product
    assert cost.flops == 9 * per_product
    # on meta the same count comes from the fake
    qm, km, vm = (t.detach().to("meta").requires_grad_() for t in (q, k, v))
    with OpCost() as meta_cost:
        ops.flash_attention(qm, km, vm, 2, **mask).sum().backward()
    assert meta_cost.flops == cost.flops


@pytest.mark.parametrize("S_q,S_k", [(10, 10), (7, 12)])
def test_kernel_fakes_make_the_twins_shapes(S_q, S_k):
    q, k, v = _qkv(S_q, S_k)
    q5 = ops._five_d(q, 2)
    k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = dict(causal=False, window=0, prefix=0)
    twin = fa.flash_fwd(q5, k4, v4, **mask)
    fake = fa.flash_fwd_op(q5.to("meta"), k4.to("meta"), v4.to("meta"),
                           False, 0, 0, 0.25)
    do5 = torch.ones_like(q5)
    twin_b = fa.flash_bwd(q5, k4, v4, do5, twin[1], twin[1], **mask)
    fake_b = fa.flash_bwd_op(*(t.to("meta") for t in (q5, k4, v4, do5,
                                                      twin[1], twin[1])),
                             False, 0, 0, 0.25)
    for got, want in zip((*fake, *fake_b), (*twin, *twin_b)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    groups = torch.randn(16, qz.GROUP).to(torch.bfloat16)
    tq, ts = qz.quantize(groups)
    fq, fs = qz.quantize_op(groups.to("meta"))
    assert (fq.shape, fq.dtype, fs.shape, fs.dtype) \
        == (tq.shape, tq.dtype, ts.shape, ts.dtype)
    for dt in (torch.float32, torch.bfloat16):
        want = qz.dequantize(tq, ts, dt)
        got = qz.dequantize_op(tq.to("meta"), ts.to("meta"), dt)
        assert (got.shape, got.dtype) == (want.shape, want.dtype)


def test_kernel_ops_on_cpu_are_the_twins():
    q, k, v = _qkv()
    mask = dict(causal=True, window=0, prefix=0)
    q5 = ops._five_d(q, 2)
    k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    out, lse = fa.flash_fwd_op(q5, k4, v4, True, 0, 0, 8 ** -0.5)
    ref_out, ref_lse = fa.flash_fwd_reference(q5, k4, v4, **mask)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    groups = torch.randn(4, qz.GROUP)
    for got, want in zip(qz.quantize_op(groups),
                         qz.quantize_reference(groups)):
        assert torch.equal(got, want)


def test_bytes_and_peak_live_bytes_by_hand():
    """Each op reads its operands and writes its result once (views and
    allocations move nothing, a *_like factory writes only); a storage
    made inside the window is live from its op to its last reference,
    views included; storages made before the window never count."""
    before = torch.empty(10_000, device="meta")
    with OpCost() as c:
        a = torch.empty(1000, device="meta")     # live 4000
        b = a * 2                                # 8000 B; live 8000
        v = b.view(10, 100)                      # free
        del a                                    # live 4000
        d = torch.ones(2000, device="meta")      # 8000 B; live 12000
        del b                                    # v holds b: live 12000
        assert c.live_bytes == 12_000
        del v                                    # live 8000
        e = d.sum()                              # 8004 B; live 8004
        d.add_(1.0)                              # 16000 B, no storage
        f = torch.zeros_like(d)                  # 8000 B; live 16004
        g = before[:500] * 1.0                   # 4000 B; live 18004
        del f                                    # live 10004
        gc.collect()
    assert c.bytes == 8000 + 8000 + 8004 + 16000 + 8000 + 4000
    assert c.peak_bytes == 18_004
    assert c.live_bytes == 10_004
    assert c.n_ops == 9
    del d, e, g
    assert c.live_bytes == 0


def test_regions_and_bucket():
    x = torch.empty(64, 64, device="meta")
    with OpCost(bucket_re=r"attn.*:aten\.mm") as c:
        with c.region("attn"):
            x @ x
            x + x
        x @ x
    mm = 2 * 64 ** 3
    assert c.flops == 2 * mm
    assert (c.bucket_flops, c.bucket_bytes) == (mm, 3 * 64 * 64 * 4)

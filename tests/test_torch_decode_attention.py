"""The decode-attention op (``repro_torch.kernels.decode_attention``) on the
CPU: its plain twin, reached through ``layers.attention_decode`` and the
custom op, held against the JAX package's ``attention_decode`` on the same
numpy inputs (fp32, 1e-5) for every family's attention at smoke size, below
the ring's length and past its wrap, with rope's bf16 products off and on;
the op's dispatch (CPU: the twin; meta: the fake; anything else raises),
with the position as an int or also as a 0-d tensor;
the split count and the route as functions of the shapes; and the FLOP and
byte formulas the dry-run's counter charges it by.  The kernel itself is
held against the twin on the card (``tests/test_torch_kernels_gpu.py``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import layers as JL
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import attention_math as am
from repro_torch.kernels import decode_attention as da
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)
S_CACHE = 12

# every family's attention: MHA, GQA with partial rotary (chatglm3 0.5,
# stablelm 0.25), MoE (qwen3, arctic), MQA (paligemma, recurrentgemma's
# local ring), and the encoder-decoder's self-attention (no rotary)
ARCH_CASES = ["deepseek-7b", "chatglm3-6b", "stablelm-3b",
              "qwen3-moe-235b-a22b", "arctic-480b", "paligemma-3b",
              "recurrentgemma-9b", "seamless-m4t-large-v2"]


def _cfgs(arch):
    return jax_smoke(JAX_ARCHS[arch]), smoke_variant(ARCHS[arch])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _attn_params(cfg, rng):
    d, D = cfg.d_model, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    return {"wq": rng.normal(0, s, (d, cfg.n_heads * D)).astype(np.float32),
            "wk": rng.normal(0, s, (d, cfg.kv_dim)).astype(np.float32),
            "wv": rng.normal(0, s, (d, cfg.kv_dim)).astype(np.float32),
            "wo": rng.normal(0, s, (cfg.n_heads * D, d)).astype(np.float32)}


@pytest.mark.parametrize("norm_bf16", [False, True])
@pytest.mark.parametrize("pos", [7, 29])
@pytest.mark.parametrize("arch", ARCH_CASES)
def test_twin_matches_jax_attention_decode(arch, pos, norm_bf16):
    """pos 7 < S_cache writes slot 7 and masks the unwritten slots; pos 29
    wraps the ring (slot 5) and sees every slot."""
    jcfg, tcfg = _cfgs(arch)
    assert tcfg.rotary_pct == jcfg.rotary_pct
    rng = np.random.default_rng(len(arch) * 100 + pos)
    p = _attn_params(jcfg, rng)
    B, Hkv, D = 2, jcfg.n_kv_heads, jcfg.head_dim
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(B, S_CACHE, Hkv, D)).astype(np.float32)
    cv = rng.normal(size=(B, S_CACHE, Hkv, D)).astype(np.float32)
    JL.set_norm_bf16(norm_bf16)
    TL.set_norm_bf16(norm_bf16)
    try:
        want, wk, wv = JL.attention_decode(
            {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jcfg,
            jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos, jnp.int32),
            jcfg.n_heads)
        tk, tv = _t(ck.copy()), _t(cv.copy())
        before = da.DECODE_ATTN_LAUNCHES
        got, gk, gv = TL.attention_decode(params_from_numpy(p, "cpu"),
                                          _t(x), tcfg, tk, tv, pos,
                                          tcfg.n_heads)
    finally:
        JL.set_norm_bf16(False)
        TL.set_norm_bf16(False)
    assert da.DECODE_ATTN_LAUNCHES == before      # the CPU runs no kernel
    assert gk is tk and gv is tv                  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    # only the slot changed
    slot = pos % S_CACHE
    keep = [i for i in range(S_CACHE) if i != slot]
    np.testing.assert_array_equal(gk.numpy()[:, keep], ck[:, keep])
    np.testing.assert_array_equal(gv.numpy()[:, keep], cv[:, keep])


def _inputs(B=2, Hq=4, Hkv=2, D=16, S=10, dtype=torch.float32,
            device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen).to(dtype).to(device)
    return (mk(B, 1, Hq, D), mk(B, 1, Hkv, D), mk(B, 1, Hkv, D),
            mk(B, S, Hkv, D), mk(B, S, Hkv, D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_on_cpu_runs_the_twin(dtype):
    q, k, v, ck, cv = _inputs(dtype=dtype)
    ck2, cv2 = ck.clone(), cv.clone()
    before = dict(da.ROUTE_LAUNCHES)
    got = da.decode_attn_op(q, k, v, ck, cv, 13, 0.5, 10000.0, False)
    want = da.decode_attention_reference(q, k, v, ck2, cv2, 13, 0.5,
                                         10000.0, False)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)
    assert da.ROUTE_LAUNCHES == before


def test_op_on_meta_runs_the_fake():
    q, k, v, ck, cv = _inputs(Hq=8, Hkv=2, D=32, dtype=torch.bfloat16,
                              device="meta")
    out = da.decode_attn_op(q, k, v, ck, cv, 3, 1.0, 10000.0, False)
    assert out.device.type == "meta"
    assert out.shape == (2, 1, 8, 32) and out.dtype == torch.bfloat16


def test_op_on_meta_takes_the_position_as_a_tensor():
    """The schema's ``pos_dev``: the fake takes a 0-d int32 tensor beside
    the int."""
    q, k, v, ck, cv = _inputs(Hq=8, Hkv=2, D=32, dtype=torch.bfloat16,
                              device="meta")
    out = da.decode_attn_op(q, k, v, ck, cv, 3, 1.0, 10000.0, False, None,
                            torch.tensor(3, dtype=torch.int32,
                                         device="meta"))
    assert out.device.type == "meta"
    assert out.shape == (2, 1, 8, 32) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["meta_wrapper", "q_len", "groups",
                                 "cache_shape", "dtype", "head_dim",
                                 "pos", "devices", "pos_dev_dtype",
                                 "pos_dev_shape", "pos_dev_device"])
def test_bad_inputs_raise(bad):
    q, k, v, ck, cv = _inputs()
    pos, pos_dev = 3, None
    if bad == "meta_wrapper":       # the wrapper never takes meta to a twin
        q, k, v, ck, cv = (t.to("meta") for t in (q, k, v, ck, cv))
    elif bad == "q_len":
        q = torch.cat([q, q], dim=1)
    elif bad == "groups":           # Hq not a multiple of Hkv
        q = q[:, :, :3]
    elif bad == "cache_shape":
        cv = cv[:, :-1]
    elif bad == "dtype":
        cv = cv.double()
    elif bad == "head_dim":
        q, k, v, ck, cv = _inputs(D=264)
    elif bad == "pos":
        pos = -1
    elif bad == "devices":
        ck = ck.to("meta")
    elif bad == "pos_dev_dtype":
        pos_dev = torch.tensor(3)
    elif bad == "pos_dev_shape":
        pos_dev = torch.tensor([3], dtype=torch.int32)
    elif bad == "pos_dev_device":
        pos_dev = torch.tensor(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        da.decode_attn(q, k, v, ck, cv, pos, 1.0, 10000.0, False, None,
                       pos_dev)


@pytest.mark.parametrize("batch,kv_blocks,n_valid,want", [
    (16, 32, 1025, (1, 1088)),    # deepseek-7b chat: 512 blocks, no split
    (16, 32, 1152, (1, 1152)),
    (4, 32, 2049, (3, 704)),      # deepseek-7b rag: 128 blocks
    (4, 4, 1025, (17, 64)),       # qwen3-moe serving: limited by the slots
    (4, 1, 2048, (32, 64)),       # recurrentgemma's wrapped window
    (1, 1, 1, (1, 64)),           # the first position
    (2, 2, 300, (5, 64)),
    (1, 8, 5000, (27, 192)),     # 33 wanted; whole tiles of 64 give 27
])
def test_decode_splits(batch, kv_blocks, n_valid, want):
    n, rows = da.decode_splits(batch, kv_blocks, n_valid)
    assert (n, rows) == want
    assert rows % da.SPLIT_ROWS == 0
    assert (n - 1) * rows < n_valid <= n * rows   # no empty split
    # no more splits than two blocks an SM need
    assert n <= max(1, -(-2 * da.NUM_SMS // (batch * kv_blocks)))


def test_decode_splits_is_a_function_of_the_shapes():
    for n_valid in range(1, 3000, 37):
        for blocks in (1, 3, 16, 128, 512, 2048):
            n, rows = da.decode_splits(1, blocks, n_valid)
            assert (n, rows) == da.decode_splits(1, blocks, n_valid)
            assert (n - 1) * rows < n_valid <= n * rows
            assert n <= max(1, -(-2 * da.NUM_SMS // blocks))


# (dtype, B, Hq, Hkv, S, the positions of a round, its plan): each serving
# cell's decode attention over its round's positions
PLAN_CASES = {
    "chat": (torch.bfloat16, 16, 32, 32, 1152, range(1024, 1151),
             ("simt", 1, 1, 1152)),
    "rag": (torch.bfloat16, 4, 32, 32, 2056, range(2048, 2055),
            ("simt", 1, 3, 704)),
    "granite_chat": (torch.bfloat16, 16, 32, 8, 1152, range(1024, 1151),
                     ("simt", 1, 3, 384)),
    "ring_past_its_wrap": (torch.bfloat16, 4, 16, 1, 2048, range(2048, 2200),
                           ("mma", 1, 32, 64)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_the_plan_holds_over_a_round(case):
    """A CUDA graph of the op serves the positions of one plan: each cell's
    round takes one, and a single split is sized by the cache, not by the
    valid slots."""
    dtype, B, Hq, Hkv, S, positions, want = PLAN_CASES[case]
    assert {da.decode_plan(dtype, B, Hq, Hkv, S, p) for p in positions} \
        == {want}
    route, n_gc, n, rows = want
    assert n == da.decode_splits(B, Hkv * n_gc, min(positions[0] + 1, S))[0]


@pytest.mark.parametrize("dtype,G,route,chunks", [
    (torch.bfloat16, 1, "simt", 1),     # deepseek, stablelm, seamless
    (torch.bfloat16, 4, "simt", 1),     # h2o-danube
    (torch.bfloat16, 7, "mma", 1),      # arctic
    (torch.bfloat16, 8, "mma", 1),      # paligemma
    (torch.bfloat16, 16, "mma", 1),     # chatglm3, qwen3-moe, recurrentgemma
    (torch.float32, 3, "simt", 1),
    (torch.float32, 7, "simt", 2),
    (torch.float32, 16, "simt", 4),
])
def test_route_and_group_chunks(dtype, G, route, chunks):
    assert da._route(dtype, G) == route
    assert da._group_chunks(route, G) == chunks


@pytest.mark.parametrize("pos", [5, 40])
def test_cost_formulas_charge_the_valid_slots(pos):
    """OpCost charges the op its FLOP formula (two products over the valid
    slots) and its byte formula (q, each valid K/V row once, the written
    slot, the output), not the twin's ops nor the whole caches."""
    B, Hq, Hkv, D, S = 2, 8, 2, 32, 24
    q, k, v, ck, cv = _inputs(B, Hq, Hkv, D, S, dtype=torch.bfloat16,
                              device="meta")
    with OpCost() as cost:
        da.decode_attn_op(q, k, v, ck, cv, pos, 1.0, 10000.0, False)
    n_valid = min(pos + 1, S)
    op = cost.by_op["repro_torch.decode_attn"]
    assert op["calls"] == 1 and cost.n_ops == 1
    assert op["flops"] == cost.flops == 2 * 2 * B * Hq * D * n_valid
    row = B * Hkv * D * 2
    assert op["bytes"] == cost.bytes \
        == 2 * B * Hq * D * 2 + 2 * row * n_valid + 2 * row
    # under the two whole caches while the ring has unwritten slots
    assert (cost.bytes < 2 * ck.numel() * 2) == (pos < S)


def test_inverse_frequencies_are_made_once(monkeypatch):
    """The one rope table that ``rope`` and ``decode_attn`` share."""
    monkeypatch.setattr(am, "_ROPE_TABLES", {})
    a = am.rope_table(torch.device("cpu"), 128, 1.0, 10000.0)
    b = am.rope_table(torch.device("cpu"), 128, 1.0, 10000.0)
    assert a[0] is b[0] and a[1] == 128
    np.testing.assert_array_equal(a[0].numpy(),
                                  TL.rope_freqs(128, 1.0, 10000.0))
    assert am.rope_table(torch.device("cpu"), 128, 0.0, 10000.0) \
        == (None, 0)
    assert am.rope_table(torch.device("cpu"), 80, 0.25, 10000.0)[1] == 20


def test_rope_copies_its_table_to_a_device_once(monkeypatch):
    """On the meta device, as on the card, the table's first call copies it
    from the host; later calls find it there and copy nothing: the one
    ``_to_copy`` left is the positions' widening to fp32."""
    monkeypatch.setattr(am, "_ROPE_TABLES", {})
    x = torch.empty((2, 16, 4, 64), device="meta")
    pos = torch.empty((2, 16), dtype=torch.int32, device="meta")
    copies = []
    for _ in range(3):
        with OpCost() as cost:
            am.rope(x, pos, 1.0, 10000.0, False)
        copies.append(cost.by_op["aten._to_copy"]["calls"])
    assert copies == [2, 1, 1]
    assert list(am._ROPE_TABLES) == [(torch.device("meta"), 64, 1.0,
                                      10000.0)]

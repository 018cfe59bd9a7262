"""The port's encoder-decoder family (seamless-m4t-large-v2) held against the
JAX package end to end on the CPU at smoke size, with 2 and 3 encoder and
decoder layers, both attention implementations (the Pallas kernel in
interpret mode), and an even (12 frames, 12 tokens) and an odd (13 frames,
12 tokens) sequence budget, so that cross-attention runs with Se != Sd.
Checked: the param tree, ``forward_train``, prefill hidden states and the
four cache leaves, decode, decode against the full forward, the serve
steps' logits and greedy tokens, gradients through both stacks and into
the encoder's output, remat, one train step, the reference's odd-S cache
split, and the flash path at Sq != Sk against the Pallas wrapper.  JAX
params are converted and the inputs are numpy arrays from a seed, so both
packages compute on the same numbers."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import ShapeConfig as JaxShape
from repro.configs import smoke_variant as jax_smoke
from repro.kernels.ops import pallas_flash_attention
from repro.models import cache_spec as jax_cache_spec
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import init_model as jax_init
from repro.models import input_specs as jax_input_specs
from repro.models import transformer as JT
from repro.serve import make_decode_step as jax_decode_step
from repro.serve import make_prefill_step as jax_prefill_step
from repro.train import lm_loss as jax_lm_loss
from repro.train import make_train_step as jax_make_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, ShapeConfig, smoke_variant
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import (cache_spec, forward_decode, forward_prefill,
                                forward_train, init_model, input_specs)
from repro_torch.models import transformer as T
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.train import OptConfig, loss_and_grads
from repro_torch.train import make_train_step

ARCH = "seamless-m4t-large-v2"
# (layers of each stack, attn_impl, frames Se); the decoder takes St tokens
CFGS = [(2, "flash", 12), (2, "flash_pallas", 13), (3, "flash", 13),
        (3, "flash_pallas", 12)]
B, St, PAD, STEPS = 2, 12, 8, 8
# fp32 on both sides, summation order only: 1e-5 relative plus 1e-5 of
# the tensor's largest |value|; gradients 1e-4 (tests/test_torch_train*)
TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# prefill + decode vs the full forward: tests/test_models.py's 0.05
DECODE_TOL = 0.05


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _cfgs(n_layers, **kw):
    kw = dict(enc_layers=n_layers, dec_layers=n_layers,
              n_layers=2 * n_layers, **kw)
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[ARCH]), **kw),
            dataclasses.replace(smoke_variant(ARCHS[ARCH]), **kw))


def _setup(n_layers, seed=0, **kw):
    jcfg, tcfg = _cfgs(n_layers, **kw)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(_tree_np(jparams), "cpu")


def _inputs(cfg, n_tokens, n_frames, seed):
    """numpy tokens (B, n_tokens) and stub frame embeddings (B, n_frames,
    d) drawn as ``make_inputs`` draws them (normal x 0.02)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, n_tokens)).astype(np.int32)
    src = (rng.normal(size=(B, n_frames, cfg.d_model)) * 0.02) \
        .astype(np.float32)
    return tokens, src


def _batches(tokens, src):
    return ({"tokens": jnp.asarray(tokens), "src_emb": jnp.asarray(src)},
            {"tokens": torch.from_numpy(tokens),
             "src_emb": torch.from_numpy(src)})


# ------------------------------ the tree ------------------------------

@pytest.mark.parametrize("n_layers", [2, 3])
def test_init_model_tree_matches_jax(n_layers):
    """Keys, shapes and dtypes in bf16: an ``encoder`` stack of attention
    blocks and a ``decoder`` stack of cross blocks (norm1, attn, norm2,
    xattn, norm3, mlp: the order of the reference's ``_block_init``)."""
    jcfg, tcfg = _cfgs(n_layers, param_dtype="bfloat16")
    want = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    got = init_model(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert list(got) == ["embed", "encoder", "decoder"]
    assert list(got["decoder"]) == [
        "norm1", "attn", "norm2", "xattn", "norm3", "mlp"]
    want, got = dict(_flat(want)), dict(_flat(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert str(got[path].dtype).split(".")[1] == str(w.dtype), path
    assert got[("encoder", "norm1")].shape[0] == n_layers
    assert got[("decoder", "xattn", "wq")].shape[0] == n_layers


def test_params_from_numpy_takes_the_encdec_tree():
    """JAX params cross over bit for bit, bf16 included."""
    jcfg, _ = _cfgs(2, param_dtype="bfloat16")
    jparams = _tree_np(jax_init(jax.random.PRNGKey(1), jcfg))
    got = dict(_flat(params_from_numpy(jparams, "cpu")))
    for path, w in _flat(jparams):
        assert got[path].dtype == torch.bfloat16, path
        np.testing.assert_array_equal(
            got[path].view(torch.int16).numpy(), w.view(np.int16))


@pytest.mark.parametrize("seq", [1056, 1025, 4096])
def test_cache_spec_and_input_specs_match_jax_at_full_width(seq):
    """24 decoder layers of k/v over Sd = S - S // 2 slots and xk/xv over
    Se = S // 2; the inputs S // 2 tokens and S - S // 2 frames."""
    cfg, jcfg = ARCHS[ARCH], JAX_ARCHS[ARCH]
    want = jax_cache_spec(jcfg, seq, 4)
    got = cache_spec(cfg, seq, 4)
    assert sorted(got) == sorted(want) == ["k", "v", "xk", "xv"]
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
    assert got["xk"].shape == (24, 4, seq // 2, 16, 64)
    for kind in ("train", "prefill", "decode"):
        want = dict(_flat(jax_input_specs(jcfg, JaxShape("c", seq, 4, kind))))
        got = dict(_flat(input_specs(cfg, ShapeConfig("c", seq, 4, kind))))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).split(".")[1] == str(w.dtype), k


def test_odd_budget_cache_split_differs_from_a_prefill_in_both():
    """The reference's quirk, kept: for an odd S, ``cache_spec`` gives the
    encoder S // 2 slots and the decoder S - S // 2, while ``input_specs``
    gives the decoder S // 2 tokens and the encoder S - S // 2 frames, so a
    prefill of the same S (default pad_to = tokens + 1) builds a cache
    whose xk/xv are one slot longer than the decode cell's.  Both packages
    agree on both shapes."""
    S = 25
    jcfg, tcfg, jparams, tparams = _setup(2)
    spec = jax_input_specs(jcfg, JaxShape("c", S, B, "prefill"))
    tokens, src = _inputs(jcfg, spec["tokens"].shape[1],
                          spec["src_emb"].shape[1], 5)
    jb, tb = _batches(tokens, src)
    _, jc = jax_prefill(jparams, jcfg, jb)
    _, tc = forward_prefill(tparams, tcfg, tb)
    jspec, tspec = jax_cache_spec(jcfg, S, B), cache_spec(tcfg, S, B)
    for name in ("k", "v", "xk", "xv"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert tuple(tspec[name].shape) == tuple(jspec[name].shape), name
    assert tc["k"].shape[2] == tspec["k"].shape[2] == 13
    assert tc["xk"].shape[2] == 13 and tspec["xk"].shape[2] == 12


# ----------------------------- serving -----------------------------

@functools.lru_cache(maxsize=None)
def _serve(n_layers, impl, Se):
    """Everything both packages compute for one config, once per module."""
    jcfg, tcfg, jparams, tparams = _setup(n_layers, seed=3, attn_impl=impl)
    tokens, src = _inputs(jcfg, St + 1, Se, n_layers + Se)
    jfb, tfb = _batches(tokens, src)
    jb, tb = _batches(tokens[:, :St], src)
    nxt = tokens[:, St:]
    r = {}
    jfull, jaux = jax_forward_train(jparams, jcfg, jfb)
    tfull, taux = forward_train(tparams, tcfg, tfb)
    r["train"] = (jfull, jaux, tfull, taux)
    jh, jc = jax.jit(functools.partial(jax_prefill, cfg=jcfg,
                                       pad_to=St + PAD))(jparams, batch=jb)
    th, tc = forward_prefill(tparams, tcfg, tb, pad_to=St + PAD)
    r["prefill"] = (jh, jc, th, {k: v.clone() for k, v in tc.items()})
    jh2, jc2 = jax.jit(functools.partial(jax_decode, cfg=jcfg))(
        jparams, cache=jc, tokens=jnp.asarray(nxt),
        pos=jnp.asarray(St, jnp.int32))
    th2, tc2 = forward_decode(tparams, tcfg, tc, torch.from_numpy(nxt), St)
    r["decode"] = (jh2, jc2, th2, tc2, tc)

    jpre = jax.jit(jax_prefill_step(jcfg, pad_to=St + PAD))
    jdec = jax.jit(jax_decode_step(jcfg))
    tpre = make_prefill_step(tcfg, pad_to=St + PAD, device="cpu")
    tdec = make_decode_step(tcfg, device="cpu")
    jl, jcache = jpre(jparams, jb)
    tl, tcache = tpre(tparams, tb)
    jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    jlog, tlog, jtoks, ttoks = [jl], [tl], [jtok], [ttok]
    for t in range(STEPS):
        jtok, jlt, jcache = jdec(jparams, jcache, jtok,
                                 jnp.asarray(St + t, jnp.int32))
        ttok, tlt, tcache = tdec(tparams, tcache, ttok, St + t)
        jlog.append(jlt)
        tlog.append(tlt)
        jtoks.append(jtok)
        ttoks.append(ttok)
    r["steps"] = (jlog, tlog, np.concatenate([np.asarray(t) for t in jtoks],
                                             1), torch.cat(ttoks, 1).numpy())
    return r


@pytest.mark.parametrize("n_layers,impl,Se", CFGS)
def test_forward_train_matches_jax(n_layers, impl, Se):
    jfull, jaux, tfull, taux = _serve(n_layers, impl, Se)["train"]
    assert tuple(tfull.shape) == (B, St + 1, 64)
    _close(tfull, jfull)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("n_layers,impl,Se", CFGS)
def test_prefill_matches_jax(n_layers, impl, Se):
    """Hidden states and the four cache leaves: self-attention k/v fitted
    to pad_to slots, cross-attention xk/xv at the encoder's Se."""
    jh, jc, th, tc = _serve(n_layers, impl, Se)["prefill"]
    _close(th, jh, name="prefill hidden")
    assert sorted(tc) == sorted(jc) == ["k", "v", "xk", "xv"]
    assert tc["k"].shape == (n_layers, B, St + PAD, 4, 16)
    assert tc["xk"].shape == (n_layers, B, Se, 4, 16)
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype)
        _close(tc[name], jc[name], name=f"prefill {name}")


@pytest.mark.parametrize("n_layers,impl,Se", CFGS)
def test_decode_matches_jax_and_updates_the_cache_in_place(n_layers, impl,
                                                           Se):
    """Self-attention k/v written in place at slot St; the cross cache
    read and left as it was."""
    jh2, jc2, th2, tc2, tc = _serve(n_layers, impl, Se)["decode"]
    _close(th2, jh2, name="decode hidden")
    assert tc2 is tc
    for name in jc2:
        _close(tc2[name], jc2[name], name=f"decode {name}")
    pre = _serve(n_layers, impl, Se)["prefill"][3]
    for name in ("xk", "xv"):
        torch.testing.assert_close(tc2[name], pre[name], rtol=0, atol=0)


@pytest.mark.parametrize("n_layers,impl,Se", CFGS)
def test_prefill_then_decode_matches_full_forward(n_layers, impl, Se):
    """The reference's test of the same name (tests/test_models.py): decode
    at position St against the full forward's last row, the frames
    unchanged."""
    r = _serve(n_layers, impl, Se)
    np.testing.assert_allclose(_np(r["decode"][2][:, 0]),
                               _np(r["train"][2][:, -1]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("n_layers,impl,Se", CFGS)
def test_serve_step_logits_and_tokens_match_jax(n_layers, impl, Se):
    jlog, tlog, jtoks, ttoks = _serve(n_layers, impl, Se)["steps"]
    assert len(jlog) == len(tlog) == STEPS + 1
    for j, t in zip(jlog, tlog):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, name="logits")
    assert ttoks.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(ttoks, jtoks)


# ----------------------------- training -----------------------------

def _jax_encode(params, cfg, src):
    """The reference's encoder (``_encdec_train``'s first half) over its
    own layer functions."""
    x = src.astype(jnp.float32)
    Bx, Se, d = x.shape
    pos = jnp.broadcast_to(jnp.arange(Se)[None], (Bx, Se))
    x = x + JT._sinusoidal(pos, d)
    n_heads = JT.params_n_heads(params, cfg)

    def step(xx, lp):
        xx, _ = JT._apply_attn_block(lp, xx, cfg, pos, n_heads=n_heads,
                                     causal=False)
        return JT._apply_mlp_or_moe(lp, xx, cfg)[0], None
    return jax.lax.scan(step, x, params["encoder"])[0]


def _jax_decoder_loss(params, cfg, tokens, enc_out):
    """The LM loss of the reference's decoder (``_encdec_train``'s second
    half) as a function of the encoder's output."""
    x, pos = JT._embed_inputs(params, cfg, {"tokens": tokens})
    n_heads = JT.params_n_heads(params, cfg)

    def step(xx, lp):
        xx, _ = JT._apply_attn_block(lp, xx, cfg, pos, n_heads=n_heads,
                                     causal=True)
        xx, _ = JT._apply_attn_block({"attn": lp["xattn"],
                                      "norm1": lp["norm3"]}, xx, cfg, pos,
                                     n_heads=n_heads, causal=False,
                                     kv_override=enc_out)
        return JT._apply_mlp_or_moe(lp, xx, cfg)[0], None
    x = jax.lax.scan(step, x, params["decoder"])[0]
    return jax_lm_loss(params, cfg, x, tokens, jnp.zeros((), jnp.float32))


@functools.lru_cache(maxsize=None)
def _grads(n_layers, impl, Se, remat=False):
    """Loss, every param's gradient, the frames' gradient and the encoder
    output's gradient, in both packages."""
    jcfg, tcfg, jparams, tparams = _setup(n_layers, attn_impl=impl,
                                          remat=remat)
    tokens, src = _inputs(jcfg, St, Se, 7)
    jb, tb = _batches(tokens, src)

    def jloss(p, s):
        h, aux = jax_forward_train(p, jcfg, dict(jb, src_emb=s))
        return jax_lm_loss(p, jcfg, h, jb["tokens"], aux)

    jl, (jg, jgs) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jparams, jb["src_emb"])
    jenc = _jax_encode(jparams, jcfg, jb["src_emb"])
    jl2, jge = jax.value_and_grad(
        lambda e: _jax_decoder_loss(jparams, jcfg, jb["tokens"], e))(jenc)

    # the port: the frames' gradient, and the encoder output's gradient
    # read where forward_train hands it to the decoder stack
    seen = {}
    run = T._run_bodies

    def watching(bodies, x, checkpointed, *extra):
        for e in extra:
            e.register_hook(lambda g: seen.setdefault("enc_out", g.clone()))
        return run(bodies, x, checkpointed, *extra)
    src_t = tb["src_emb"].clone().requires_grad_()
    T._run_bodies = watching
    try:
        tl, _, tg = loss_and_grads(tparams, tcfg, dict(tb, src_emb=src_t))
    finally:
        T._run_bodies = run
    for p in jax.tree.leaves(tparams):            # params left as found
        assert not p.requires_grad and p.grad is None
    return (float(jl), _tree_np(jg), np.asarray(jgs), float(jl2),
            np.asarray(jge), float(tl), tg, src_t.grad, seen["enc_out"])


@pytest.mark.parametrize("n_layers,impl,Se", CFGS)
def test_loss_grads_match_jax(n_layers, impl, Se):
    """Every leaf of both stacks gets its gradient, through the per-layer
    flush of each stack."""
    jl, jg, _, _, _, tl, tg, _, _ = _grads(n_layers, impl, Se)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    want, got = dict(_flat(jg)), dict(_flat(tg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert torch.isfinite(got[path]).all(), path
        _close(got[path], w, GRAD_TOL, str(path))
        if path[0] != "embed":
            assert float(got[path].abs().sum()) > 0, path


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_layers,impl,Se", CFGS[:2])
def test_gradient_into_the_encoder_output_matches_jax(n_layers, impl, Se,
                                                      remat):
    """The encoder's output feeds every decoder layer's cross-attention;
    its gradient (summed over the layers, under remat too) and the frames'
    gradient behind it match the reference's."""
    jl, _, jgs, jl2, jge, tl, _, tgs, tge = _grads(n_layers, impl, Se, remat)
    np.testing.assert_allclose(jl2, jl, **LOSS_TOL)  # the recomposition
    assert tuple(tge.shape) == (B, Se, 64)
    _close(tge, jge, GRAD_TOL, "d loss / d enc_out")
    _close(tgs, jgs, GRAD_TOL, "d loss / d src_emb")
    assert float(tge.abs().min(dim=-1).values.max()) > 0


@pytest.mark.parametrize("n_layers,impl,Se", CFGS[:2])
def test_remat_matches_no_remat(n_layers, impl, Se):
    """Checkpointed encoder and decoder layers recompute the same forward:
    identical grads, the encoder output's and the frames' included."""
    _, _, _, _, _, tl0, tg0, ts0, te0 = _grads(n_layers, impl, Se)
    _, _, _, _, _, tl1, tg1, ts1, te1 = _grads(n_layers, impl, Se, True)
    assert tl0 == tl1
    for (path, a), (_, b) in zip(_flat(tg0), _flat(tg1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))
    torch.testing.assert_close(ts0, ts1, rtol=0, atol=0)
    torch.testing.assert_close(te0, te1, rtol=0, atol=0)


@pytest.mark.parametrize("optimizer,compression", [
    ("adamw", False), ("adafactor", True)])
def test_train_step_matches_jax(optimizer, compression):
    """One ``make_train_step`` step (the frames passed through), held as
    tests/test_torch_train.py holds the dense steps: elementwise within
    1e-5 + 1e-4 relative but for at most 0.1 % of the elements (0.5 % with
    int8 compression), none further off than twice the learning rate."""
    jcfg, tcfg, jparams, tparams = _setup(
        2, attn_impl="flash_pallas", optimizer=optimizer,
        grad_compression=compression)
    jstate = jopt.opt_init(optimizer, jparams)
    tstate = opt_state_from_numpy(_tree_np(jstate), "cpu")
    jb, tb = _batches(*_inputs(jcfg, St, 13, 10))
    jparams, jstate, jm = jax.jit(jax_make_train_step(jcfg))(
        jparams, jstate, jb)
    tparams, tstate, tm = make_train_step(tcfg, device="cpu")(
        tparams, tstate, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    n_all = n_bad = 0
    got = dict(_flat(tparams))
    for path, w in _flat(_tree_np(jparams)):
        diff = np.abs(_np(got[path]) - w)
        n_all += diff.size
        n_bad += int((diff > 1e-5 + 1e-4 * np.abs(w)).sum())
        assert diff.max() <= 2 * OptConfig().lr, (path, diff.max())
    assert n_bad / n_all <= (5e-3 if compression else 1e-3)
    assert int(tstate["count"]) == int(jstate["count"]) == 1


# ------------------- the flash path at Sq != Sk -------------------

@pytest.mark.parametrize("D", [64, 256])
def test_cross_attention_flash_matches_pallas_wrapper(D):
    """``ops.flash_attention`` bidirectional with 12 decoder queries over
    20 encoder keys (16 heads, as seamless), out and q/k/v gradients
    against the JAX package's Pallas wrapper in interpret mode, at
    tests/test_flash_kernels.py's 3e-4 / 4e-3; on CPU tensors the
    wrapper takes its plain version and counts no launch."""
    rng = np.random.default_rng(D)
    q = rng.normal(size=(2, 12, 4, D)).astype(np.float32)
    k = rng.normal(size=(2, 20, 4, D)).astype(np.float32)
    v = rng.normal(size=(2, 20, 4, D)).astype(np.float32)
    jfn = lambda *a: pallas_flash_attention(*a, 4, False, 0, 0, 16, 32)
    want = jfn(*map(jnp.asarray, (q, k, v)))
    jg = jax.grad(lambda *a: (jfn(*a) ** 2).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    out = flash_attention(qt, kt, vt, 4, False, 0, 0)
    (out ** 2).sum().backward()
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == before
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    for t, w, name in zip((qt, kt, vt), jg, "qkv"):
        assert tuple(t.grad.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=4e-3,
                                   atol=4e-3, err_msg=name)

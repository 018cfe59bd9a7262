"""The port's prefix-LM VLM family (paligemma-3b) held against the JAX
package end to end on the CPU at smoke size (4 stub patch embeddings as a
bidirectional prefix, MQA: 4 query heads over 1 KV head), at 2 and 3
layers with both attention implementations (the Pallas kernel in
interpret mode).  Checked: the param tree, the inputs, ``forward_train``,
prefill hidden states and caches, decode, decode against the full forward,
the serve steps' logits and greedy tokens, gradients, remat, one train
step, the loss over text positions only, the prefix mask itself, and the
flash path's prefix mask at D = 64 and D = 256 against the Pallas wrapper.
JAX params are converted and the inputs are numpy arrays from a seed, so
both packages compute on the same numbers."""
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
                                forward_train, init_model, input_specs,
                                make_inputs)
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.train import OptConfig, lm_loss, loss_and_grads
from repro_torch.train import make_train_step
from repro_torch.train.loss import chunked_softmax_xent

ARCH = "paligemma-3b"
CFGS = [(2, "flash"), (2, "flash_pallas"), (3, "flash"), (3, "flash_pallas")]
# B rows of P = 4 patches and St text tokens; decode PAD slots past them
B, St, PAD, STEPS = 2, 20, 8, 8
P = 4
TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
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
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[ARCH]), n_layers=n_layers,
                                **kw),
            dataclasses.replace(smoke_variant(ARCHS[ARCH]), n_layers=n_layers,
                                **kw))


def _setup(n_layers, seed=0, **kw):
    jcfg, tcfg = _cfgs(n_layers, **kw)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(_tree_np(jparams), "cpu")


def _inputs(cfg, n_tokens, seed):
    """numpy tokens (B, n_tokens) and stub patch embeddings (B, P, d), drawn
    as ``make_inputs`` draws them (normal x 0.02)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, n_tokens)).astype(np.int32)
    patches = (rng.normal(size=(B, cfg.n_prefix_tokens, cfg.d_model))
               * 0.02).astype(np.float32)
    return tokens, patches


def _batches(tokens, patches):
    return ({"tokens": jnp.asarray(tokens),
             "prefix_emb": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(tokens),
             "prefix_emb": torch.from_numpy(patches)})


# ------------------------------ the tree ------------------------------

@pytest.mark.parametrize("n_layers", [2, 3])
def test_init_model_tree_matches_jax(n_layers):
    jcfg, tcfg = _cfgs(n_layers, param_dtype="bfloat16")
    want = dict(_flat(jax.eval_shape(
        lambda: jax_init(jax.random.PRNGKey(0), jcfg))))
    got = dict(_flat(init_model(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert str(got[path].dtype).split(".")[1] == str(w.dtype), path
    assert got[("blocks", "attn", "wk")].shape == (n_layers, 64, 16)


def test_params_from_numpy_takes_the_vlm_tree():
    jcfg, _ = _cfgs(2, param_dtype="bfloat16")
    jparams = _tree_np(jax_init(jax.random.PRNGKey(1), jcfg))
    got = dict(_flat(params_from_numpy(jparams, "cpu")))
    for path, w in _flat(jparams):
        assert got[path].dtype == torch.bfloat16, path
        np.testing.assert_array_equal(
            got[path].view(torch.int16).numpy(), w.view(np.int16))


@pytest.mark.parametrize("seq", [1024, 4096])
def test_input_and_cache_specs_match_jax_at_full_width(seq):
    """256 patch embeddings of d 2048 in bf16 and S - 256 tokens; the
    cache over all S positions (18 layers of one 256-wide KV head)."""
    cfg, jcfg = ARCHS[ARCH], JAX_ARCHS[ARCH]
    for kind in ("train", "prefill", "decode"):
        want = dict(_flat(jax_input_specs(jcfg, JaxShape("c", seq, 2, kind))))
        got = dict(_flat(input_specs(cfg, ShapeConfig("c", seq, 2, kind))))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
    spec = input_specs(cfg, ShapeConfig("c", seq, 2, "train"))
    assert spec["prefix_emb"].shape == (2, 256, 2048)
    assert spec["tokens"].shape == (2, seq - 256)
    assert cache_spec(cfg, seq, 2)["k"].shape == (18, 2, seq, 1, 256)
    assert tuple(jax_cache_spec(jcfg, seq, 2)["k"].shape) == \
        (18, 2, seq, 1, 256)


def test_make_inputs_draws_the_patches_from_the_generator():
    _, tcfg = _cfgs(2)
    shape = ShapeConfig("c", 24, B, "train")
    a = make_inputs(torch.Generator().manual_seed(4), tcfg, shape,
                    device="cpu")
    b = make_inputs(torch.Generator().manual_seed(4), tcfg, shape,
                    device="cpu")
    assert list(a) == ["tokens", "prefix_emb"]
    assert a["prefix_emb"].shape == (B, P, 64)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert 0 < float(a["prefix_emb"].abs().max()) < 0.2


# ----------------------------- serving -----------------------------

@functools.lru_cache(maxsize=None)
def _serve(n_layers, impl):
    jcfg, tcfg, jparams, tparams = _setup(n_layers, seed=3, attn_impl=impl)
    tokens, patches = _inputs(jcfg, St + 1, n_layers + len(impl))
    jfb, tfb = _batches(tokens, patches)
    jb, tb = _batches(tokens[:, :St], patches)
    nxt = tokens[:, St:]
    S = P + St                    # the prompt's positions, patches first
    r = {}
    jfull, jaux = jax_forward_train(jparams, jcfg, jfb)
    tfull, taux = forward_train(tparams, tcfg, tfb)
    r["train"] = (jfull, jaux, tfull, taux)
    jh, jc = jax.jit(functools.partial(jax_prefill, cfg=jcfg,
                                       pad_to=S + PAD))(jparams, batch=jb)
    th, tc = forward_prefill(tparams, tcfg, tb, pad_to=S + PAD)
    r["prefill"] = (jh, jc, th, {k: v.clone() for k, v in tc.items()})
    jh2, jc2 = jax.jit(functools.partial(jax_decode, cfg=jcfg))(
        jparams, cache=jc, tokens=jnp.asarray(nxt),
        pos=jnp.asarray(S, jnp.int32))
    th2, tc2 = forward_decode(tparams, tcfg, tc, torch.from_numpy(nxt), S)
    r["decode"] = (jh2, jc2, th2, tc2, tc)

    jpre = jax.jit(jax_prefill_step(jcfg, pad_to=S + PAD))
    jdec = jax.jit(jax_decode_step(jcfg))
    tpre = make_prefill_step(tcfg, pad_to=S + PAD, device="cpu")
    tdec = make_decode_step(tcfg, device="cpu")
    jl, jcache = jpre(jparams, jb)
    tl, tcache = tpre(tparams, tb)
    jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    jlog, tlog, jtoks, ttoks = [jl], [tl], [jtok], [ttok]
    for t in range(STEPS):
        jtok, jlt, jcache = jdec(jparams, jcache, jtok,
                                 jnp.asarray(S + t, jnp.int32))
        ttok, tlt, tcache = tdec(tparams, tcache, ttok, S + t)
        jlog.append(jlt)
        tlog.append(tlt)
        jtoks.append(jtok)
        ttoks.append(ttok)
    r["steps"] = (jlog, tlog, np.concatenate([np.asarray(t) for t in jtoks],
                                             1), torch.cat(ttoks, 1).numpy())
    return r


@pytest.mark.parametrize("n_layers,impl", CFGS)
def test_forward_train_matches_jax(n_layers, impl):
    """Hidden states over the patches and the text."""
    jfull, jaux, tfull, taux = _serve(n_layers, impl)["train"]
    assert tuple(tfull.shape) == (B, P + St + 1, 64)
    _close(tfull, jfull)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("n_layers,impl", CFGS)
def test_prefill_matches_jax(n_layers, impl):
    jh, jc, th, tc = _serve(n_layers, impl)["prefill"]
    _close(th, jh, name="prefill hidden")
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    assert tc["k"].shape == (n_layers, B, P + St + PAD, 1, 16)
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        _close(tc[name], jc[name], name=f"prefill {name}")


@pytest.mark.parametrize("n_layers,impl", CFGS)
def test_decode_matches_jax_and_updates_the_cache_in_place(n_layers, impl):
    jh2, jc2, th2, tc2, tc = _serve(n_layers, impl)["decode"]
    _close(th2, jh2, name="decode hidden")
    assert tc2 is tc
    for name in jc2:
        _close(tc2[name], jc2[name], name=f"decode {name}")


@pytest.mark.parametrize("n_layers,impl", CFGS)
def test_prefill_then_decode_matches_full_forward(n_layers, impl):
    """tests/test_models.py's identity: decode at position P + St against
    the full forward's last row."""
    r = _serve(n_layers, impl)
    np.testing.assert_allclose(_np(r["decode"][2][:, 0]),
                               _np(r["train"][2][:, -1]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("n_layers,impl", CFGS)
def test_serve_step_logits_and_tokens_match_jax(n_layers, impl):
    jlog, tlog, jtoks, ttoks = _serve(n_layers, impl)["steps"]
    assert len(jlog) == len(tlog) == STEPS + 1
    for j, t in zip(jlog, tlog):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, name="logits")
    np.testing.assert_array_equal(ttoks, jtoks)


def test_the_prefix_is_bidirectional_and_the_text_causal():
    """A later patch reaches the first position's hidden state; a text
    token reaches no patch's and no earlier token's."""
    _, tcfg, _, tparams = _setup(2)
    tokens, patches = _inputs(tcfg, St, 1)
    base = forward_train(tparams, tcfg, _batches(tokens, patches)[1])[0]
    patches2 = patches.copy()
    patches2[:, P - 1] += 1.0
    moved = forward_train(tparams, tcfg, _batches(tokens, patches2)[1])[0]
    assert float((moved[:, 0] - base[:, 0]).abs().max()) > 1e-3
    tokens2 = tokens.copy()
    tokens2[:, 5] = (tokens2[:, 5] + 1) % tcfg.vocab_size
    moved = forward_train(tparams, tcfg, _batches(tokens2, patches)[1])[0]
    torch.testing.assert_close(moved[:, :P + 5], base[:, :P + 5], rtol=0,
                               atol=0)
    assert float((moved[:, P + 5] - base[:, P + 5]).abs().max()) > 1e-3


# ----------------------------- training -----------------------------

@functools.lru_cache(maxsize=None)
def _grads(n_layers, impl, remat=False):
    jcfg, tcfg, jparams, tparams = _setup(n_layers, attn_impl=impl,
                                          remat=remat)
    jb, tb = _batches(*_inputs(jcfg, St, 7))

    def jloss(p):
        h, aux = jax_forward_train(p, jcfg, jb)
        return jax_lm_loss(p, jcfg, h, jb["tokens"], aux)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tl, _, tg = loss_and_grads(tparams, tcfg, tb)
    for p in jax.tree.leaves(tparams):
        assert not p.requires_grad and p.grad is None
    return float(jl), _tree_np(jg), float(tl), tg


@pytest.mark.parametrize("n_layers,impl", CFGS)
def test_loss_grads_match_jax(n_layers, impl):
    jl, jg, tl, tg = _grads(n_layers, impl)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    want, got = dict(_flat(jg)), dict(_flat(tg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert torch.isfinite(got[path]).all(), path
        _close(got[path], w, GRAD_TOL, str(path))
        if path[0] != "embed":
            assert float(got[path].abs().sum()) > 0, path


@pytest.mark.parametrize("n_layers", [2, 3])
def test_remat_matches_no_remat(n_layers):
    _, _, tl0, tg0 = _grads(n_layers, "flash_pallas")
    _, _, tl1, tg1 = _grads(n_layers, "flash_pallas", remat=True)
    assert tl0 == tl1
    for (path, a), (_, b) in zip(_flat(tg0), _flat(tg1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))


def test_loss_drops_the_prefix_positions():
    """``lm_loss`` reads the text positions only: it equals the chunked
    cross-entropy of the hidden states past the P patches (and the
    reference's ``lm_loss``), and no gradient reaches a patch position."""
    jcfg, tcfg, jparams, tparams = _setup(2)
    tokens = _inputs(tcfg, St, 3)[0]
    hidden = np.random.default_rng(9).normal(
        size=(B, P + St, 64)).astype(np.float32)
    h = torch.from_numpy(hidden).requires_grad_()
    zero = torch.zeros(())
    loss = lm_loss(tparams, tcfg, h, torch.from_numpy(tokens), zero)
    want = jax_lm_loss(jparams, jcfg, jnp.asarray(hidden),
                       jnp.asarray(tokens), jnp.zeros((), jnp.float32))
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               **LOSS_TOL)
    labels = torch.cat([torch.from_numpy(tokens[:, 1:]),
                        torch.zeros((B, 1), dtype=torch.int32)], dim=1)
    mask = torch.ones((B, St))
    mask[:, -1] = 0
    text = chunked_softmax_xent(h[:, P:].detach(), tparams["embed"], labels,
                                mask)
    torch.testing.assert_close(loss.detach(), text, rtol=0, atol=0)
    loss.backward()
    assert float(h.grad[:, :P].abs().max()) == 0.0
    assert float(h.grad[:, P:-1].abs().min(dim=-1).values.min()) > 0


def test_train_step_matches_jax():
    """One AdamW ``make_train_step`` step (the patches passed through), as
    tests/test_torch_train.py holds the dense steps."""
    jcfg, tcfg, jparams, tparams = _setup(2, attn_impl="flash_pallas")
    jstate = jopt.opt_init("adamw", jparams)
    tstate = opt_state_from_numpy(_tree_np(jstate), "cpu")
    jb, tb = _batches(*_inputs(jcfg, St, 10))
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
    assert n_bad / n_all <= 1e-3


# ------------------- the flash path's prefix mask -------------------

@pytest.mark.parametrize("D", [64, 256])
def test_prefix_flash_matches_pallas_wrapper(D):
    """``ops.flash_attention`` causal with an 8-position bidirectional
    prefix over S = 24, 8 query heads over 1 KV head (paligemma's G), out
    and q/k/v gradients against the JAX package's Pallas wrapper in
    interpret mode, at tests/test_flash_kernels.py's 3e-4 / 4e-3."""
    rng = np.random.default_rng(D + 1)
    q = rng.normal(size=(2, 24, 8, D)).astype(np.float32)
    k = rng.normal(size=(2, 24, 1, D)).astype(np.float32)
    v = rng.normal(size=(2, 24, 1, D)).astype(np.float32)
    jfn = lambda *a: pallas_flash_attention(*a, 1, True, 0, 8, 8, 8)
    want = jfn(*map(jnp.asarray, (q, k, v)))
    jg = jax.grad(lambda *a: (jfn(*a) ** 2).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    out = flash_attention(qt, kt, vt, 1, True, 0, 8)
    (out ** 2).sum().backward()
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == before
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    for t, w, name in zip((qt, kt, vt), jg, "qkv"):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=4e-3,
                                   atol=4e-3, err_msg=name)

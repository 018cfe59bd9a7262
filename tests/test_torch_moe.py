"""The port's MoE layer (``repro_torch.models.moe``) held against the JAX
package's ``repro.models.moe`` on the CPU at smoke size: ``moe_ffn``'s
output and aux loss with and without dropped tokens, over token groups, at
decode's shape, with arctic's dense branch and with all-equal router
probabilities (the top-k tie rule), and its gradients with the default
products and with the hand-written expert backward.  JAX params are
converted, so both packages compute on the same numbers; the inputs are
numpy arrays from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import moe as JM
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as M

QWEN, ARCTIC = "qwen3-moe-235b-a22b", "arctic-480b"
# fp32 on both sides; the differences are summation order only.  y is held
# at 1e-5 relative plus 1e-5 of its largest |value| (the smoke experts'
# 1/sqrt(E) scale makes outputs of O(10)); the aux loss at 1e-6.
Y_TOL = 1e-5
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = 1e-4


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), **kw),
            dataclasses.replace(smoke_variant(ARCHS[arch]), **kw))


def _params(jcfg, seed=0, zero_router=False):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, d, seed=1):
    return (np.random.default_rng(seed).normal(size=(*shape, d)) * 0.3) \
        .astype(np.float32)


def _assert_close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


# (arch, capacity_factor, n_groups, (B, S), drops expected, router zeroed)
CASES = {
    "no_drops": (QWEN, 8.0, 1, (2, 16), False, False),
    "no_drops_4_groups": (QWEN, 8.0, 4, (4, 8), False, False),
    "drops": (QWEN, 1.0, 1, (4, 16), True, False),
    "drops_4_groups": (QWEN, 1.0, 4, (4, 32), True, False),
    "groups_not_dividing": (QWEN, 1.0, 3, (4, 16), True, False),
    "decode_shape": (QWEN, 1.25, 1, (4, 1), False, False),
    "arctic_dense_branch": (ARCTIC, 1.25, 1, (2, 16), None, False),
    "equal_probs_ties": (QWEN, 1.25, 1, (2, 16), True, True),
}


def _run(name):
    arch, cf, n_groups, shape, _, zero = CASES[name]
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(jcfg, zero_router=zero)
    x = _x(shape, jcfg.d_model)
    jy, jaux = JM.moe_ffn(jp, jnp.asarray(x), jcfg, n_groups=n_groups)
    ty, taux = M.moe_ffn(tp, torch.from_numpy(x), tcfg, n_groups=n_groups)
    return tcfg, tp, x, (jy, jaux), (ty, taux)


def _routing(tcfg, tp, x, n_groups):
    B, S, d = x.shape
    G = n_groups if (B * S) % n_groups == 0 else 1
    Tg = B * S // G
    return M.route(tp["router"], torch.from_numpy(x).reshape(G, Tg, d),
                   tcfg.experts_per_token, M._capacity(Tg, tcfg))


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_jax(name):
    tcfg, tp, x, (jy, jaux), (ty, taux) = _run(name)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _assert_close(ty, jy, Y_TOL, name)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)
    drops_expected = CASES[name][4]
    if drops_expected is not None:
        r = _routing(tcfg, tp, x, CASES[name][2])
        n_dropped = int((~r.keep).sum())
        # a drop case is not vacuous, a no-drop case drops nothing
        assert (n_dropped > 0) == drops_expected, n_dropped


def test_equal_probabilities_pick_the_lowest_experts():
    """A zero router gives every expert probability 1/E: every token picks
    experts 0..k-1 in that order (jax.lax.top_k's tie rule) with equal
    gates, and under capacity pressure the lower choice and then the lower
    token keep their slots."""
    tcfg, tp, x, _, _ = _run("equal_probs_ties")
    r = _routing(tcfg, tp, x, 1)
    k, C = tcfg.experts_per_token, r.capacity
    T = x.shape[0] * x.shape[1]
    assert torch.equal(r.expert[0], torch.arange(k).expand(T, k))
    # choice 0 of every token goes to expert 0, choice 1 to expert 1: each
    # expert's first C tokens keep their slot
    want_keep = (torch.arange(T) < C)[:, None].expand(T, k)
    assert torch.equal(r.keep[0], want_keep)
    assert torch.equal(r.flat_pos[0, :C, 1], C + torch.arange(C))
    kept_gate = r.gate[0][want_keep]
    torch.testing.assert_close(kept_gate, torch.full_like(kept_gate, 1 / k))


@pytest.mark.parametrize("tokens", [1, 7, 8, 32, 100, 1000, 4096, 4100])
@pytest.mark.parametrize("arch,cf", [(QWEN, 1.25), (QWEN, 16.0),
                                     (ARCTIC, 1.25)])
def test_capacity_matches_jax(tokens, arch, cf):
    """At full width, as the card runs them."""
    jcfg = dataclasses.replace(JAX_ARCHS[arch], capacity_factor=cf)
    tcfg = dataclasses.replace(ARCHS[arch], capacity_factor=cf)
    assert M._capacity(tokens, tcfg) == JM._capacity(tokens, jcfg)


@pytest.mark.parametrize("arch", [QWEN, ARCTIC])
def test_init_moe_shapes_and_dtypes_match_jax(arch):
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    want = jax.eval_shape(lambda: JM.init_moe(jax.random.PRNGKey(0), jcfg))
    got = M.init_moe(torch.Generator().manual_seed(0), tcfg)
    want = {k: v for k, v in jax.tree_util.tree_leaves_with_path(want)}
    flat = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v
    walk(got)
    want = {tuple(p.key for p in path): v for path, v in want.items()}
    assert sorted(flat) == sorted(want)
    for path, w in want.items():
        assert tuple(flat[path].shape) == tuple(w.shape), path
        assert str(flat[path].dtype).split(".")[1] == str(w.dtype), path
    assert flat[("router",)].dtype == torch.float32


def _grads(expert_cvjp, arch=QWEN, cf=1.0):
    """d(sum(y * w) + aux)/d(params, x) from both packages, in a case with
    drops."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf,
                       moe_expert_cvjp=expert_cvjp)
    jp, tp = _params(jcfg)
    x = _x((4, 16), jcfg.d_model)
    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_ffn(p, xx, jcfg)
        return jnp.sum(y * w) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    leaves = {}

    def arm(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                arm(v, path + (k,))
            else:
                v.requires_grad_()
                leaves[path + (k,)] = v
    arm(tp)
    y, aux = M.moe_ffn(tp, tx, tcfg)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    jflat = {tuple(p.key for p in path): v for path, v in
             jax.tree_util.tree_leaves_with_path(jg_p)}
    return leaves, jflat, tx.grad, jg_x


@pytest.mark.parametrize("expert_cvjp", [False, True])
def test_moe_ffn_grads_match_jax(expert_cvjp):
    leaves, jflat, gx, jgx = _grads(expert_cvjp)
    assert sorted(leaves) == sorted(jflat)
    for path, leaf in leaves.items():
        _assert_close(leaf.grad, jflat[path], GRAD_TOL, str(path))
    _assert_close(gx, jgx, GRAD_TOL, "x")


def test_arctic_grads_reach_the_dense_branch():
    leaves, jflat, gx, jgx = _grads(False, arch=ARCTIC, cf=1.25)
    for path in [p for p in leaves if p[0] == "dense"]:
        assert float(leaves[path].grad.abs().max()) > 0, path
        _assert_close(leaves[path].grad, jflat[path], GRAD_TOL, str(path))
    _assert_close(gx, jgx, GRAD_TOL, "x")


def test_dispatch_and_combine_are_gathers_of_the_slot_map():
    """Empty slots are zero rows, dropped choices add nothing: with the
    expert FFN the identity, combine(dispatch(x)) is x times the sum of a
    token's kept gates."""
    tcfg, tp, x, _, _ = _run("drops")
    r = _routing(tcfg, tp, x, 1)
    xf = torch.from_numpy(x).reshape(1, -1, x.shape[-1])
    buf = M.dispatch(xf, r)
    E, C = tcfg.n_experts, r.capacity
    assert tuple(buf.shape) == (1, E, C, x.shape[-1])
    used = torch.zeros(E * C, dtype=torch.bool)
    used[r.flat_pos[r.keep]] = True
    assert float(buf.reshape(E * C, -1)[~used].abs().max()) == 0.0
    y = M.combine(buf, r)
    want = xf * r.gate.sum(-1, keepdim=True)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)

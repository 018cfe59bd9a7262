"""The port's storage seam held against the JAX package on the CPU: its copy
of the store simulator is byte-identical to ``repro.core``; its
``Checkpointer`` writes the same manifests (paths, dtype strings, shapes,
checksums, shard ranges) and the same leaf bytes as the JAX one for the same
tree, in both layouts, and restores them bit for bit; and the reference
checkpoint tests' stories hold for tensor trees."""
import dataclasses
import pathlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import Checkpointer as JaxCheckpointer
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.core import Pool as JaxPool
from repro.core import Topology as JaxTopology
from repro.core.interfaces import DFS as JaxDFS
from repro.models import init_model as jax_init
from repro.train import opt_init as jax_opt_init
from repro_torch.ckpt import Checkpointer, CheckpointError, CheckpointManager
from repro_torch.ckpt import serializer as S
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core import Pool, Topology
from repro_torch.core.interfaces import DFS
from repro_torch.kernels import checksum as ck
from repro_torch.tree import tree_items

ROOT = pathlib.Path(__file__).resolve().parents[1]


def make_tree(seed=0, scale=1.0):
    """tests/test_ckpt.py's tree, as numpy (the JAX side saves it so)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": (rng.normal(size=(64, 128)) * scale).astype(np.float32),
            "b": (rng.normal(size=(128,)) * scale).astype(np.float32),
            "emb": (rng.normal(size=(1000, 32)) * scale).astype("bfloat16"),
        },
        "opt": {"m": np.zeros((64, 128), np.float32),
                "count": np.asarray(7, np.int32)},
    }


def driver_tree(param_dtype):
    """The JAX driver's own state at smoke size: init_model(PRNGKey(0))
    and Adafactor's opt_init, as numpy."""
    cfg = dataclasses.replace(jax_smoke(JAX_ARCHS["deepseek-7b"]),
                              param_dtype=param_dtype)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    state = jax_opt_init("adafactor", params)
    return jax.tree.map(np.asarray, {"params": params, "opt": state})


def _worlds():
    jpool = JaxPool(JaxTopology(n_server_nodes=4, engines_per_node=2))
    pool = Pool(Topology(n_server_nodes=4, engines_per_node=2))
    return ((jpool, JaxDFS(jpool.create_container("ck", oclass="S2"))),
            (pool, DFS(pool.create_container("ck", oclass="S2"))))


def _bytes_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _assert_tree_bits_equal(got: dict, want: dict) -> None:
    got, want = dict(S.flatten_tree(got)), dict(S.flatten_tree(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert _bytes_equal(got[path], np.asarray(w)), path


@pytest.fixture()
def world():
    pool = Pool(Topology(n_server_nodes=4, engines_per_node=2))
    return pool, DFS(pool.create_container("ck", oclass="S2"))


# ------------------------------ the simulator ------------------------------

def test_core_is_a_byte_identical_copy():
    ref = ROOT / "src" / "repro" / "core"
    port = ROOT / "src" / "repro_torch" / "core"
    names = sorted(p.relative_to(ref) for p in ref.rglob("*.py"))
    assert len(names) == 27
    assert sorted(p.relative_to(port) for p in port.rglob("*.py")) == names
    for rel in names:
        assert (port / rel).read_bytes() == (ref / rel).read_bytes(), rel


@pytest.mark.parametrize("pkg", ["ckpt/manager.py", "data/pipeline.py",
                                 "data/synthetic.py", "ft/failures.py"])
def test_copied_modules_are_unchanged(pkg):
    assert (ROOT / "src" / "repro_torch" / pkg).read_bytes() == \
        (ROOT / "src" / "repro" / pkg).read_bytes()


# ------------------------- manifests and bytes vs JAX -------------------------

@pytest.mark.parametrize("layout", ["sharded", "shared"])
@pytest.mark.parametrize("tree_name", ["make_tree", "driver_fp32",
                                       "driver_bf16"])
def test_manifest_and_bytes_equal_jax(layout, tree_name):
    tree = {"make_tree": make_tree,
            "driver_fp32": lambda: driver_tree("float32"),
            "driver_bf16": lambda: driver_tree("bfloat16")}[tree_name]()
    (_, jdfs), (_, dfs) = _worlds()
    jck = JaxCheckpointer(jdfs, interface="dfs", oclass="RP_2GX",
                          layout=layout, n_writers=4)
    pck = Checkpointer(dfs, interface="dfs", oclass="RP_2GX", layout=layout,
                       n_writers=4)
    jck.save(3, tree, extra_meta={"step": 3})
    pck.save(3, params_from_numpy(tree, "cpu"), extra_meta={"step": 3})
    jman, pman = jck.load_manifest(3), pck.load_manifest(3)
    assert pman == jman
    n_writers = pman["n_writers"]
    for path, entry in pman["leaves"].items():
        assert _bytes_equal(pck._read_leaf(entry, n_writers=n_writers),
                            jck._read_leaf(entry, n_writers=n_writers)), path

    back = pck.restore(3, params_from_numpy(tree, "cpu"))
    for path, leaf in S.flatten_tree(back):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
    _assert_tree_bits_equal(tree_to_numpy(back, ml_dtypes.bfloat16), tree)
    _assert_tree_bits_equal(
        tree_to_numpy(back, ml_dtypes.bfloat16),
        jax.tree.map(np.asarray, jck.restore(3, tree)))


def test_leaf_to_bytes_meta_matches_numpy_names():
    tree = make_tree()
    for path, a in S.flatten_tree(tree):
        t = params_from_numpy(a, "cpu")
        raw, meta = S.leaf_to_bytes(t)
        assert meta == {"shape": list(a.shape), "dtype": str(a.dtype)}, path
        assert raw.tobytes() == np.ascontiguousarray(a).tobytes()
        back = S.bytes_to_leaf(raw.copy(), meta)
        assert back.dtype == t.dtype and torch.equal(
            back.reshape(-1).view(torch.uint8), t.reshape(-1).view(
                torch.uint8))


# ------------------- the reference checkpoint tests, tensors -------------------

@pytest.mark.parametrize("layout", ["sharded", "shared"])
@pytest.mark.parametrize("interface", ["dfs", "posix", "daos-array"])
def test_save_restore_exact(world, layout, interface):
    pool, dfs = world
    ck_ = Checkpointer(dfs, interface=interface, layout=layout, n_writers=4,
                       base=f"/ck_{layout}_{interface}")
    tree = params_from_numpy(make_tree(), "cpu")
    ck_.save(3, tree)
    back = dict(tree_items(ck_.restore(3, tree)))
    assert sorted(back) == sorted(dict(tree_items(tree)))
    for path, a in tree_items(tree):
        b = back[path]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), path


def test_async_save_snapshot_semantics_under_in_place_updates(world):
    """The port's step updates params in place: an async save must hold
    the values it was given, whatever happens to the tensors after it
    returns."""
    pool, dfs = world
    ck_ = Checkpointer(dfs, layout="sharded", n_writers=4)
    tree = params_from_numpy(make_tree(), "cpu")
    want = {p: t.clone() for p, t in tree_items(tree)}
    ev = ck_.async_save(5, tree)
    tree["params"]["w"].mul_(0.0)                 # in place, immediately
    tree["params"]["emb"].add_(1.0)
    tree["opt"]["count"].add_(1)
    ev.wait()
    back = ck_.restore(5, tree)
    for p, t in tree_items(back):
        assert torch.equal(t, want[p]), p
    assert [t["op"] for t in ck_.timings] == ["snapshot", "save", "restore"]


def test_manager_walks_back_to_restorable(world):
    """Newest checkpoint corrupted -> restore falls back to the previous."""
    pool, dfs = world
    ck_ = Checkpointer(dfs, layout="sharded", oclass="S2", n_writers=4)
    mgr = CheckpointManager(ck_, save_every=1, keep_n=5)
    trees = {s: params_from_numpy(make_tree(seed=s), "cpu") for s in range(3)}
    for s in range(3):
        mgr.maybe_save(s, trees[s], async_=False)
    man = ck_.load_manifest(2)
    fname = man["leaves"]["/params/w"]["shards"][0]["file"]
    dfs.open_file(fname).punch()
    step, back = mgr.restore_latest(params_from_numpy(make_tree(), "cpu"),
                                    pool=pool)
    assert step == 1
    assert torch.equal(back["params"]["w"], trees[1]["params"]["w"])


def test_checkpoint_verify_detects_tamper(world):
    pool, dfs = world
    ck_ = Checkpointer(dfs, layout="shared", n_writers=2)
    tree = params_from_numpy(make_tree(), "cpu")
    ck_.save(9, tree)
    entry = ck_.load_manifest(9)["leaves"]["/params/w"]
    obj = dfs.open_file(entry["file"])
    # tamper with stored bytes bypassing checksummed engine API:
    lay = obj._layout()
    eng = pool.engines[lay.shard_for_chunk(entry["offset"]
                                           // obj.stripe_cell)]
    key = (dfs.cont.label, obj.oid, "arr",
           entry["offset"] // obj.stripe_cell)
    versions = eng._store[key]
    rec = versions[max(versions)]
    buf = bytearray(rec.data)
    buf[10] ^= 0xFF
    rec.data = bytes(buf)
    with pytest.raises(Exception):   # engine csum or manifest csum fires
        ck_.restore(9, tree)


def test_manifest_checksum_mismatch_raises_checkpoint_error(world):
    """A manifest whose checksum disagrees with the bytes is refused."""
    pool, dfs = world
    ck_ = Checkpointer(dfs, layout="sharded", n_writers=2)
    tree = params_from_numpy(make_tree(), "cpu")
    man = ck_.save(4, tree)
    assert man["leaves"]["/params/b"]["csum"] == \
        S.checksum_leaf(tree["params"]["b"])
    orig = S.checksum_leaf
    try:
        S.checksum_leaf = lambda leaf: orig(leaf) ^ 1
        with pytest.raises(CheckpointError, match="checksum mismatch"):
            ck_.restore(4, tree)
    finally:
        S.checksum_leaf = orig


def test_cpu_leaves_never_launch_the_kernel(world):
    pool, dfs = world
    before = ck.CHECKSUM_LAUNCHES
    ck_ = Checkpointer(dfs, layout="sharded", n_writers=2)
    tree = params_from_numpy(make_tree(), "cpu")
    ck_.async_save(1, tree).wait()
    ck_.restore(1, tree)
    assert ck.CHECKSUM_LAUNCHES == before


def test_leaf_of_another_type_is_refused(world):
    pool, dfs = world
    ck_ = Checkpointer(dfs, layout="sharded", n_writers=2)
    with pytest.raises(TypeError, match="tensor"):
        ck_.save(1, {"w": np.zeros(4, np.float32)})


# ------------------- serving from restored params (port) -------------------

def test_serving_consistency_after_ckpt_roundtrip():
    """Restored params must produce identical prefill logits and decode
    tokens (the port's counterpart of tests/test_system.py's check)."""
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import init_model

    cfg = smoke_variant(ARCHS["chatglm3-6b"])
    gen = torch.Generator().manual_seed(1)
    params = init_model(gen, cfg, device="cpu")
    pool = Pool(Topology(n_server_nodes=2, engines_per_node=2))
    dfs = DFS(pool.create_container("m", oclass="RP_2GX"))
    ck_ = Checkpointer(dfs, layout="sharded", n_writers=2)
    ck_.save(0, params)
    restored = ck_.restore(0, params)
    back = dict(tree_items(restored))
    for path, a in tree_items(params):
        assert torch.equal(a, back[path])
        assert a.data_ptr() != back[path].data_ptr()   # nothing aliases

    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                           dtype=torch.int32)
    prefill = make_prefill_step(cfg, device="cpu")
    lg1, cache1 = prefill(params, {"tokens": tokens})
    lg2, cache2 = prefill(restored, {"tokens": tokens})
    assert torch.equal(lg1, lg2)
    dec = make_decode_step(cfg, device="cpu")
    t1, d1, _ = dec(params, cache1, torch.zeros((2, 1), dtype=torch.int32),
                    15)
    t2, d2, _ = dec(restored, cache2, torch.zeros((2, 1), dtype=torch.int32),
                    15)
    assert torch.equal(t1, t2) and torch.equal(d1, d2)

"""The port's serving store (``repro_torch.serve.KVCacheStore``) held against
the JAX package's on the CPU, and the reference store's stories on tensor
leaves.

Parity: for the same trees, in the same worlds, the port writes the JAX
store's manifest JSON, session-index record and leaf bytes, its offloads and
restores cost the same modeled seconds, and it restores tensors bit-equal to
the JAX restore.  The trees are tests/test_serve_kvcache.py's ``make_cache``
and the smoke prefill caches of deepseek-7b and chatglm3-6b (fp32 and
bf16) computed by the port from converted JAX params.

Stories: every test of tests/test_serve_kvcache.py and the store half of
tests/test_tiering.py's serving tests, with torch leaves; plus what only a
store of mutable tensors can break (in-place updates after an offload or
after a restore) and the CPU path of the store's timings."""
import dataclasses
import json
import pathlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.core import Pool as JaxPool
from repro.core import Topology as JaxTopology
from repro.core.interfaces import DFS as JaxDFS
from repro.models import init_model as jax_init
from repro.serve import KVCacheStore as JaxKVCacheStore
from repro_torch.ckpt import serializer as S
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core import Pool, Topology
from repro_torch.core.interfaces import DFS, make_interface
from repro_torch.models import forward_decode
from repro_torch.serve import KVCacheStore, KVStoreError, make_prefill_step
from test_serve_kvcache import make_cache as np_make_cache

MOUNTS = ["dfs", "posix", "posix-cached", "posix-cached:timeout=0.5",
          "posix-readahead", "dfs-cached", "daos-array"]


def to_torch(tree):
    """A numpy tree (dicts, lists, tuples) as the same tree of tensors that
    own copies of the bytes."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return tensor_from_numpy(tree, "cpu")


def make_cache(seed=0, leaf_kib=16, n_layers=3):
    """tests/test_serve_kvcache.py's cache, as tensors."""
    return to_torch(np_make_cache(seed, leaf_kib, n_layers))


def leaf_bytes(leaf) -> bytes:
    return S.leaf_to_bytes(leaf)[0].tobytes()


def assert_tree_equal(got, want):
    """Container kinds, dtypes, shapes and bytes (random bytes viewed as
    float32 hold NaNs, so values are compared as bytes)."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_equal(g, w)
    else:
        assert isinstance(got, torch.Tensor)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert leaf_bytes(got) == leaf_bytes(want)


class _Poison(torch.Tensor):
    """A tensor leaf whose copy to host bytes fails mid-offload."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.detach:
            raise RuntimeError("leaf materialisation failed")
        return super().__torch_function__(func, types, args, kwargs or {})


def poison():
    return torch.zeros(4).as_subclass(_Poison)


def store_on(dfs, **kw):
    return KVCacheStore(dfs, device="cpu", **kw)


@pytest.fixture()
def world():
    """conftest's default world, on the port's copy of the simulator."""
    pool = Pool(Topology(), materialize=True)
    dfs = DFS(pool.create_container("c", oclass="S2"))
    dfs.mkdir("/d")
    return pool, dfs


# ------------------------------------------------------- parity with JAX --
def _worlds():
    jpool = JaxPool(JaxTopology(n_server_nodes=4, engines_per_node=2))
    pool = Pool(Topology(n_server_nodes=4, engines_per_node=2))
    return ((jpool, JaxDFS(jpool.create_container("kv", oclass="S2"))),
            (pool, DFS(pool.create_container("kv", oclass="S2"))))


def prefill_cache(arch, dtype):
    """The port's smoke prefill cache of ``arch`` from the JAX params,
    converted: {"k", "v"} of (L, B, S_cache, n_kv, D)."""
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), param_dtype=dtype)
    cfg = dataclasses.replace(smoke_variant(ARCHS[arch]), param_dtype=dtype)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg)),
        "cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    _, cache = make_prefill_step(cfg, pad_to=28, device="cpu")(
        params, {"tokens": torch.from_numpy(tokens)})
    return cache


def to_numpy(tree):
    """A tensor tree as the JAX side holds it: numpy, bf16 as ml_dtypes."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    raw, meta = S.leaf_to_bytes(tree, copy=True)
    dtype = ml_dtypes.bfloat16 if meta["dtype"] == "bfloat16" \
        else np.dtype(meta["dtype"])
    return raw.view(dtype).reshape(meta["shape"])


PARITY_TREES = {
    "make_cache": lambda: make_cache(seed=4),
    "deepseek_fp32": lambda: prefill_cache("deepseek-7b", "float32"),
    "deepseek_bf16": lambda: prefill_cache("deepseek-7b", "bfloat16"),
    "chatglm_fp32": lambda: prefill_cache("chatglm3-6b", "float32"),
    "chatglm_bf16": lambda: prefill_cache("chatglm3-6b", "bfloat16"),
}


@pytest.mark.parametrize("mount", ["dfs", "posix-cached", "daos-array"])
@pytest.mark.parametrize("tree_name", sorted(PARITY_TREES))
def test_manifest_index_bytes_and_modeled_times_equal_jax(tree_name, mount):
    tree = PARITY_TREES[tree_name]()
    (jpool, jdfs), (pool, dfs) = _worlds()
    # a low multipart threshold sends the hot restore through the part fan
    kw = dict(interface=mount, n_writers=4, mp_threshold=8 << 10)
    jst = JaxKVCacheStore(jdfs, **kw)
    pst = store_on(dfs, **kw)
    jtree = to_numpy(tree)
    with jpool.sim.phase() as jw:
        jout = jst.offload("sess", jtree, step=7, extra_meta={"arch": "x"})
    with pool.sim.phase() as pw:
        pout = pst.offload("sess", tree, step=7, extra_meta={"arch": "x"})
    assert pout == jout
    assert pw.elapsed == jw.elapsed
    assert bytes(pst._manifest_kv("sess").get("manifest", "json")) == \
        bytes(jst._manifest_kv("sess").get("manifest", "json"))
    assert bytes(pst._sessions_kv().get("sess", "meta")) == \
        bytes(jst._sessions_kv().get("sess", "meta"))
    man = pst.manifest("sess")
    for path, entry in man["leaves"].items():
        got = pst.iface.open(entry["file"]).read_at(0, entry["nbytes"])
        want = jst.iface.open(entry["file"]).read_at(0, entry["nbytes"])
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path

    for node in (None, 5):          # hot restore, then a foreign reader
        with jpool.sim.phase() as jr:
            jback = jst.restore("sess", client_node=node)
        with pool.sim.phase() as pr:
            back = pst.restore("sess", client_node=node)
        assert pr.elapsed == jr.elapsed
        assert_tree_equal(back, tree)
        jflat = dict(S.flatten_tree(jback))
        for path, leaf in S.flatten_tree(back):
            assert leaf.device.type == "cpu"
            assert leaf_bytes(leaf) == np.asarray(jflat[path]).tobytes()
    win_j = jst.restore_window("sess", 100, 5000)
    win_p = pst.restore_window("sess", 100, 5000)
    assert sorted(win_p) == sorted(win_j)
    for path in win_j:
        assert win_p[path].dtype == np.uint8
        np.testing.assert_array_equal(win_p[path], win_j[path])
    assert pool.sim.clock.now == jpool.sim.clock.now


def test_timings_split_every_offload_and_restore(world):
    _, dfs = world
    store = store_on(dfs, interface="dfs")
    store.offload("s", make_cache(), step=1)
    store.restore("s")
    off, res = store.timings
    assert off["op"] == "offload" and off["session"] == "s" and \
        off["step"] == 1
    assert res["op"] == "restore" and res["session"] == "s"
    for rec, keys in ((off, ("checksum_s", "to_host_s", "store_s")),
                      (res, ("read_s", "to_device_s", "checksum_s"))):
        assert all(rec[k] >= 0.0 for k in keys), rec


# ------------------------------------------- mutable tensors (the port's) --
def test_in_place_update_after_offload_leaves_snapshot(world):
    _, dfs = world
    store = store_on(dfs, interface="posix-cached")
    cache = make_cache(seed=2)
    want = {p: leaf_bytes(v) for p, v in S.flatten_tree(cache)}
    store.offload("s", cache, step=0)
    for layer in cache["layers"]:        # decode writes the cache in place
        layer["k"].zero_()
        layer["v"].fill_(3.0)
    back = store.restore("s")
    assert {p: leaf_bytes(v) for p, v in S.flatten_tree(back)} == want


def test_decode_in_place_on_a_restore_leaves_a_second_restore(world):
    """A restored CPU cache shares no memory with the store: decoding in
    place from it leaves the stored snapshot, and a second restore, as
    offloaded."""
    _, dfs = world
    cfg = smoke_variant(ARCHS["deepseek-7b"])
    cache = prefill_cache("deepseek-7b", "float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), jax_smoke(JAX_ARCHS["deepseek-7b"]))), "cpu")
    store = store_on(dfs, interface="daos-array")
    store.offload("s", cache, step=20)
    first = store.restore("s")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for t in range(4):
        forward_decode(params, cfg, first, tok, 20 + t)
    assert not torch.equal(first["k"], cache["k"])     # decode wrote
    assert_tree_equal(store.restore("s"), cache)
    assert_tree_equal(store.restore("s", client_node=3), cache)


# ------------------------------------------------------------- identity --
@pytest.mark.parametrize("mount", MOUNTS)
def test_offload_restore_byte_identity(world, mount):
    pool, dfs = world
    store = store_on(dfs, interface=mount)
    cache = make_cache()
    store.offload("sess0", cache, step=3)
    assert_tree_equal(store.restore("sess0"), cache)
    # a reader on a foreign node round-trips identically too (through its
    # own cache tier when the mount has one)
    assert_tree_equal(store.restore("sess0", client_node=5), cache)
    assert store.step("sess0") == 3
    assert store.sessions() == ["sess0"]
    assert store.nbytes("sess0") == sum(
        x.numel() * x.element_size() for x in
        [leaf for lay in cache["layers"] for leaf in lay.values()]
        + list(cache["meta"]))


def test_republish_overwrites_in_place(world):
    pool, dfs = world
    store = store_on(dfs, interface="posix-cached")
    store.offload("s", make_cache(seed=1), step=0)
    new = make_cache(seed=2)
    store.offload("s", new, step=1)
    assert store.step("s") == 1
    assert_tree_equal(store.restore("s"), new)
    assert store.sessions() == ["s"]    # same session, not a second one


def test_restore_unknown_session_raises(world):
    _, dfs = world
    store = store_on(dfs, interface="dfs")
    with pytest.raises(KVStoreError):
        store.restore("nope")
    with pytest.raises(KVStoreError):
        store.step("nope")


def test_restore_detects_corruption(world):
    pool, dfs = world
    store = store_on(dfs, interface="dfs")
    store.offload("s", make_cache(), step=0)
    man = store.manifest("s")
    path, entry = next(iter(man["leaves"].items()))
    h = store.iface.open(entry["file"])
    h.write_at(0, np.zeros(64, np.uint8))       # out-of-band scribble
    with pytest.raises(KVStoreError, match="checksum mismatch"):
        store.restore("s")


# ------------------------------------------------------------ atomicity --
@pytest.mark.parametrize("mount", ["posix", "posix-cached", "daos-array"])
def test_torn_offload_leaves_prior_snapshot_restorable(world, mount):
    pool, dfs = world
    store = store_on(dfs, interface=mount)
    cache0 = make_cache(seed=0)
    store.offload("s", cache0, step=0)
    poisoned = make_cache(seed=9)
    # the poison sits in a LATER leaf (sorted paths), so earlier leaves
    # are already staged — exactly the torn-writer window
    poisoned["layers"][-1]["v"] = poison()
    with pytest.raises(RuntimeError, match="materialisation"):
        store.offload("s", poisoned, step=1)
    assert store.step("s") == 0
    assert_tree_equal(store.restore("s"), cache0)
    assert_tree_equal(store.restore("s", client_node=3), cache0)


def test_first_offload_torn_publishes_nothing(world):
    pool, dfs = world
    store = store_on(dfs, interface="posix-cached")
    poisoned = make_cache()
    poisoned["layers"][-1]["v"] = poison()
    with pytest.raises(RuntimeError):
        store.offload("s", poisoned, step=0)
    with pytest.raises(KVStoreError):
        store.restore("s")
    assert store.sessions() == []       # index record never committed


# ------------------------------------------------------------------- gc --
@pytest.mark.parametrize("mount", ["posix", "posix-cached", "daos-array"])
def test_evict_gcs_manifest_index_and_leaves(world, mount):
    pool, dfs = world
    store = store_on(dfs, interface=mount)
    store.offload("a", make_cache(seed=0), step=0)
    store.offload("b", make_cache(seed=1), step=0)
    man_a = store.manifest("a")
    assert store.sessions() == ["a", "b"]
    store.evict("a")
    assert store.sessions() == ["b"]
    with pytest.raises(KVStoreError):
        store.manifest("a")
    for entry in man_a["leaves"].values():
        if store.iface.has_namespace:
            with pytest.raises(FileNotFoundError):
                store.iface.open(entry["file"])
        else:
            assert store.iface.stat(entry["file"])["size"] == 0
    assert_tree_equal(store.restore("b"), make_cache(seed=1))
    store.evict("b")
    assert store.sessions() == []


@pytest.mark.parametrize("mount", ["posix", "daos-array"])
def test_shrinking_republish_gcs_stranded_leaves(world, mount):
    pool, dfs = world
    store = store_on(dfs, interface=mount)
    big = {f"l{i}": torch.full((256,), i, dtype=torch.uint8)
           for i in range(6)}
    small = {f"l{i}": torch.full((256,), 9 + i, dtype=torch.uint8)
             for i in range(2)}
    store.offload("s", big, step=0)
    man_big = store.manifest("s")
    store.offload("s", small, step=1)
    gone = {e["file"] for e in man_big["leaves"].values()} \
        - {e["file"] for e in store.manifest("s")["leaves"].values()}
    assert len(gone) == 4
    for f in gone:
        if store.iface.has_namespace:
            with pytest.raises(FileNotFoundError):
                store.iface.open(f)
        else:
            assert store.iface.stat(f)["size"] == 0
    assert_tree_equal(store.restore("s"), small)
    # a torn republish must NOT collect anything
    poisoned = {"l0": torch.zeros(256, dtype=torch.uint8), "l1": poison()}
    with pytest.raises(RuntimeError):
        store.offload("s", poisoned, step=2)
    assert_tree_equal(store.restore("s"), small)


def test_evict_sweeps_strays_and_tolerates_unknown(world):
    pool, dfs = world
    store = store_on(dfs, interface="posix")
    store.offload("s", make_cache(), step=0)
    h = store.iface.create("/kvcache/s/stray.tmp")
    h.write_at(0, np.zeros(16, np.uint8))
    store.evict("s")
    with pytest.raises(FileNotFoundError):
        store.iface.open("/kvcache/s/stray.tmp")
    store.evict("s")
    store.evict("never-offloaded")
    assert store.sessions() == []


# ------------------------------------------------------------ coherence --
def test_foreign_republish_visible_to_cached_readers_within_tau(world):
    pool, dfs = world
    tau = 0.4
    store = store_on(dfs, interface=f"posix-cached:timeout={tau}",
                     n_writers=1)
    reader = store_on(dfs, interface=store.iface, verify_on_restore=False)
    cache0, cache1 = make_cache(seed=0), make_cache(seed=1)
    store.offload("s", cache0, step=0)
    assert_tree_equal(reader.restore("s", client_node=5), cache0)  # warm
    store.offload("s", cache1, step=1)   # foreign update (node 0 writes)
    stale = reader.restore("s", client_node=5)
    flat = lambda c: [leaf_bytes(x) for lay in c["layers"]
                      for x in lay.values()]
    for got, old, new in zip(flat(stale), flat(cache0), flat(cache1)):
        assert got in (old, new)
    pool.sim.clock.advance(tau + 0.01)
    assert_tree_equal(reader.restore("s", client_node=5), cache1)
    co = store.iface.coherence_stats()
    assert co["max_staleness_s"] <= tau + 1e-9
    assert co["revalidations"] >= 1


def test_broadcast_readers_see_republish_immediately(world):
    pool, dfs = world
    store = store_on(dfs, interface="posix-cached", n_writers=1)
    cache0, cache1 = make_cache(seed=0), make_cache(seed=1)
    store.offload("s", cache0, step=0)
    assert_tree_equal(store.restore("s", client_node=6), cache0)
    store.offload("s", cache1, step=1)
    assert_tree_equal(store.restore("s", client_node=6), cache1)


def test_hot_restore_hits_writer_caches(world):
    pool, dfs = world
    store = store_on(dfs, interface="posix-cached")
    store.offload("s", make_cache(leaf_kib=64), step=0)
    st0 = store.iface.cache_stats()
    store.restore("s")        # default placement: each leaf on its writer
    st1 = store.iface.cache_stats()
    hits = st1.get("read_hits", 0) - st0.get("read_hits", 0)
    misses = st1.get("read_misses", 0) - st0.get("read_misses", 0)
    assert hits / max(1, hits + misses) >= 0.9


# -------------------------------------------------------- session index --
def test_session_meta_is_index_only_when_fresh(world, monkeypatch):
    _, dfs = world
    store = store_on(dfs, interface="daos-array")
    store.offload("s", make_cache(), step=4)
    man = store.manifest("s")
    want = {"step": 4,
            "nbytes": sum(int(e["nbytes"]) for e in man["leaves"].values()),
            "n_leaves": len(man["leaves"]), "tier": "hot"}
    monkeypatch.setattr(
        store, "manifest",
        lambda s: (_ for _ in ()).throw(AssertionError("manifest walk")))
    assert store.session_meta("s") == want


def test_stale_index_falls_back_to_manifest_and_repairs(world, monkeypatch):
    _, dfs = world
    store = store_on(dfs, interface="posix")
    store.offload("s", make_cache(), step=2)
    want = store.session_meta("s")
    store._sessions_kv().put("s", "meta", b"not json")
    assert store.session_meta("s") == want
    monkeypatch.setattr(
        store, "manifest",
        lambda s: (_ for _ in ()).throw(AssertionError("manifest walk")))
    assert store.session_meta("s") == want
    assert json.loads(bytes(store._sessions_kv().get("s", "meta"))) == want


def test_session_meta_unknown_session_raises(world):
    _, dfs = world
    store = store_on(dfs, interface="posix")
    with pytest.raises(KVStoreError):
        store.session_meta("never")


# ------------------------------------------------------ partial restore --
@pytest.mark.parametrize("mount", ["dfs", "posix-cached", "daos-array"])
def test_partial_restore_matches_full_window(world, mount):
    _, dfs = world
    store = store_on(dfs, interface=mount)
    store.offload("s", make_cache(seed=3), step=0)
    man = store.manifest("s")
    flat = dict(S.flatten_tree(store.restore("s")))
    lo, hi = 64, 4096
    win = store.restore_window("s", lo, hi, man=man)
    assert sorted(win) == sorted(man["leaves"])
    for path, arr in win.items():
        assert isinstance(arr, np.ndarray) and arr.dtype == np.uint8
        np.testing.assert_array_equal(
            arr, S.leaf_to_bytes(flat[path])[0][lo:hi])
    path = max(man["leaves"], key=lambda p: man["leaves"][p]["nbytes"])
    np.testing.assert_array_equal(
        store.restore_slice("s", path, lo, hi, man=man), win[path])
    nb = int(man["leaves"][path]["nbytes"])
    assert store.restore_slice("s", path, nb - 8, nb + 999).size == 8
    assert store.restore_slice("s", path, nb + 1, nb + 2).size == 0
    assert store.restore_window("s", nb, nb + 4)[path].size == 0


def test_restore_accepts_memoized_manifest(world):
    _, dfs = world
    store = store_on(dfs, interface="posix-cached")
    cache = make_cache(seed=5)
    store.offload("s", cache, step=0)
    man = store.manifest("s")
    assert_tree_equal(store.restore("s", client_node=4, man=man), cache)


def test_acceptance_no_raw_ioctx_in_serve():
    import repro_torch.serve as serve
    root = pathlib.Path(serve.__file__).parent
    for f in root.glob("*.py"):
        text = f.read_text()
        assert "IOCtx" not in text and "make_ctx" not in text, f.name


# ------------------------------------------------- tiering: demote/promote --
def _tree(n_leaves=4, leaf_kib=64, seed=0):
    rng = np.random.default_rng(seed)
    return {f"layer{i:03d}": torch.from_numpy(
        rng.integers(0, 255, (leaf_kib << 10,), dtype=np.uint8))
        for i in range(n_leaves)}


def _tiered_store(dfs):
    iface = make_interface("tiered://hot=dfs,cold=cold", dfs)
    return store_on(dfs, interface=iface, n_writers=2), iface


def test_kvstore_demote_promote_roundtrip(world):
    pool, dfs = world
    store, iface = _tiered_store(dfs)
    cache = _tree(seed=3)
    store.offload("s0", cache, step=4)
    assert store.tier("s0") == "hot"
    files = [e["file"] for e in store.manifest("s0")["leaves"].values()]
    store.demote("s0")
    assert store.tier("s0") == "cold"
    assert store.session_meta("s0")["tier"] == "cold"
    assert all(iface.in_cold(f) for f in files)
    for f in files:                         # hot copies really gone
        with pytest.raises((FileNotFoundError, KeyError)):
            iface.hot.stat(f)
    assert iface.demotions >= len(files)
    back = store.restore("s0")
    assert_tree_equal(back, cache)
    assert store.tier("s0") == "hot"
    assert store.session_meta("s0")["tier"] == "hot"
    assert not any(iface.in_cold(f) for f in files)
    assert store.session_meta("s0")["step"] == 4


def test_kvstore_torn_demotion_never_strands(world):
    pool, dfs = world
    store, iface = _tiered_store(dfs)
    cache = _tree(seed=5)
    store.offload("s0", cache, step=0)
    with pytest.raises(KVStoreError, match="injected demotion fault"):
        store.demote("s0", _fail_after=1)
    assert store.tier("s0") == "hot"
    assert_tree_equal(store.restore("s0"), cache)
    store.demote("s0")
    assert store.tier("s0") == "cold"
    assert_tree_equal(store.restore("s0"), cache)


def test_kvstore_demote_requires_tiered_mount(world):
    _pool, dfs = world
    store = store_on(dfs, interface="dfs")
    store.offload("s0", _tree(), step=0)
    with pytest.raises(KVStoreError, match="tiered://"):
        store.demote("s0")
    with pytest.raises(KVStoreError, match="tiered://"):
        store.promote("s0")

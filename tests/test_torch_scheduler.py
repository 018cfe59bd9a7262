"""The port's fleet scheduler (``repro_torch.serve.ServeScheduler``) held
against the JAX package's on the CPU, and the reference scheduler's stories
on tensor leaves.

Parity: one seeded churn sequence (arrivals, returns, windows, node
failures, quota evictions) through both schedulers over their own stores
gives the same routes, evictions, stats and modeled seconds.  Stories:
tests/test_serve_scheduler.py, the speculation tests of
tests/test_kv_batch.py, the scheduler half of tests/test_tiering.py's
serving tests and tests/test_failure_tier.py's serving failover, with torch
leaves; plus the size of a cache read without a copy."""
import numpy as np
import pytest
import torch

from repro.core import Pool as JaxPool
from repro.core import Topology as JaxTopology
from repro.core.interfaces import DFS as JaxDFS
from repro.serve import KVCacheStore as JaxKVCacheStore
from repro.serve import ServeScheduler as JaxServeScheduler
from repro_torch.ckpt import serializer as S
from repro_torch.core import Pool, Topology
from repro_torch.core.interfaces import DFS, make_interface
from repro_torch.serve import (KVCacheStore, KVStoreError, SchedulerError,
                               ServeScheduler)
from repro_torch.serve.scheduler import _tree_nbytes

LEAF_KIB = 4
N_LEAVES = 4
SESS_BYTES = N_LEAVES * (LEAF_KIB << 10)


def np_cache(seed=0, leaf_kib=LEAF_KIB, n_leaves=N_LEAVES):
    """tests/test_serve_scheduler.py's cache (numpy)."""
    rng = np.random.default_rng(seed)
    return {f"l{i:02d}": rng.integers(0, 255, (leaf_kib << 10,), np.uint8)
            for i in range(n_leaves)}


def make_cache(seed=0, leaf_kib=LEAF_KIB, n_leaves=N_LEAVES):
    return {k: torch.from_numpy(v)
            for k, v in np_cache(seed, leaf_kib, n_leaves).items()}


@pytest.fixture()
def world():
    pool = Pool(Topology(), materialize=True)
    dfs = DFS(pool.create_container("c", oclass="S2"))
    dfs.mkdir("/d")
    return pool, dfs


@pytest.fixture
def sched_world(world):
    pool, dfs = world
    store = KVCacheStore(dfs, interface="posix-cached",
                         verify_on_restore=False, device="cpu")
    return pool, store


# ------------------------------------------------------- parity with JAX --
def _churn(sched, store, pool, cache_of, restore_bytes, seed=11):
    """A seeded churn sequence; returns every decision and reading, in
    order."""
    rng = np.random.default_rng(seed)
    log = []
    step = 0
    live: list[str] = []
    for _ in range(80):
        op = int(rng.integers(0, 5))
        if op == 0 or not live:
            s = f"s{int(rng.integers(0, 10)):02d}"
            n_leaves = int(rng.integers(1, 6))
            with pool.sim.phase() as ph:
                evicted = sched.offload(s, cache_of(step, n_leaves),
                                        step=step)
            live = sorted(set(live) - set(evicted) | {s})
            log.append(("offload", s, evicted, ph.elapsed))
            step += 1
        elif op == 1:
            s = str(rng.choice(live))
            with pool.sim.phase() as ph:
                n = sched.begin(s)
                got = store.restore(s, client_node=n)
            sched.end(s, n)
            log.append(("restore", s, n, ph.elapsed, sorted(
                (p, restore_bytes(v)) for p, v in S.flatten_tree(got))))
        elif op == 2:
            s = str(rng.choice(live))
            with pool.sim.phase() as ph:
                n = sched.route(s)
                win = store.restore_window(s, 512, 3000, client_node=n)
            log.append(("window", s, n, ph.elapsed,
                        sorted((p, a.tobytes()) for p, a in win.items())))
        elif op == 3:
            down = int(rng.integers(0, 4))
            sched.mark_down(down)
            log.append(("route-down", down, sched.route(str(
                rng.choice(live)))))
            sched.mark_up(down)
        else:
            s = f"s{int(rng.integers(0, 10)):02d}"
            try:
                log.append(("reserve", s, sched.reserve(
                    s, int(rng.integers(1, 4)) * SESS_BYTES)))
            except SchedulerError as e:
                log.append(("reserve-refused", s, str(e)))
            live = sorted(set(live) & set(store.sessions()))
            if not live:
                live = []
        log.append(("stats", sched.stats(), sched.lru_sessions(),
                    store.sessions()))
    log.append(("clock", pool.sim.clock.now))
    return log


def test_churn_decisions_and_modeled_times_equal_jax():
    topo = dict(n_server_nodes=4, engines_per_node=2, n_client_nodes=8)
    jpool = JaxPool(JaxTopology(**topo), materialize=True)
    pool = Pool(Topology(**topo), materialize=True)
    jstore = JaxKVCacheStore(JaxDFS(jpool.create_container("c", "S2")),
                             interface="posix-cached", n_writers=4)
    store = KVCacheStore(DFS(pool.create_container("c", "S2")),
                         interface="posix-cached", n_writers=4,
                         device="cpu")
    kw = dict(nodes=range(4), max_active=2, quota_bytes=8 * SESS_BYTES,
              node_cache_bytes=3 * SESS_BYTES, speculate_window=1024)
    want = _churn(JaxServeScheduler(jstore, **kw), jstore, jpool,
                  lambda seed, n: np_cache(seed, n_leaves=n),
                  lambda a: np.asarray(a).tobytes())
    got = _churn(ServeScheduler(store, **kw), store, pool,
                 lambda seed, n: make_cache(seed, n_leaves=n),
                 lambda t: S.leaf_to_bytes(t)[0].tobytes())
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g[:3], w[:3])
    kinds = {e[0] for e in want}
    assert {"offload", "restore", "window", "route-down",
            "reserve"} <= kinds


# ------------------------------------------------------ size without copy --
def test_tree_nbytes_reads_shapes_not_bytes():
    cache = {"k": torch.empty((30, 4, 1056, 32, 128), dtype=torch.bfloat16,
                              device="meta"),
             "v": torch.empty((30, 4, 1056, 32, 128), dtype=torch.bfloat16,
                              device="meta"),
             "pos": (torch.empty((), dtype=torch.int32, device="meta"),)}
    assert _tree_nbytes(cache) == 2 * 1_038_090_240 + 4
    host = S.HostLeaf(*S.leaf_to_bytes(torch.zeros(10, dtype=torch.int16)))
    assert _tree_nbytes({"a": host, "b": torch.zeros(3)}) == 20 + 12
    with pytest.raises(TypeError, match="tensor"):
        _tree_nbytes({"a": np.zeros(3)})


# --------------------------------------------------------------- routing --
def test_returning_session_lands_on_its_last_node(sched_world):
    _, store = sched_world
    sched = ServeScheduler(store, nodes=range(4))
    sched.offload("a", make_cache(seed=1))
    sched.offload("b", make_cache(seed=2))
    na = sched.begin("a")
    sched.end("a", na)
    nb = sched.begin("b", node=(na + 1) % 4)
    sched.end("b", nb)
    for _ in range(3):
        assert sched.route("a") == na
        assert sched.route("b") == nb
    assert sched.affinity("a", na) == 1.0
    assert sched.affinity("a", nb) == 0.0


def test_route_reads_one_index_record_per_decision(sched_world, monkeypatch):
    _, store = sched_world
    sched = ServeScheduler(store, nodes=range(4))
    sched.offload("s", make_cache())
    real_kv = store._sessions_kv()
    gets = []

    class _CountingKV:
        def get(self, dkey, akey):
            gets.append((dkey, akey))
            return real_kv.get(dkey, akey)

        def __getattr__(self, name):
            return getattr(real_kv, name)

    monkeypatch.setattr(store, "_sessions_kv", lambda: _CountingKV())
    monkeypatch.setattr(
        store, "manifest",
        lambda s: (_ for _ in ()).throw(AssertionError("manifest walk")))
    before = sched.stats()
    for _ in range(5):
        sched.route("s")
    after = sched.stats()
    assert after["decisions"] - before["decisions"] == 5
    assert after["index_reads"] - before["index_reads"] == 5
    assert gets == [("s", "meta")] * 5


def test_saturated_warm_node_sheds_to_next_best_live(sched_world):
    _, store = sched_world
    sched = ServeScheduler(store, nodes=range(3), max_active=2)
    sched.offload("s", make_cache())
    n = sched.begin("s")
    sched.end("s", n)
    sched.begin("x1", node=n)
    sched.begin("x2", node=n)
    f0 = sched.stats()["failovers"]
    alt = sched.route("s")
    assert alt != n and sched.node_state(alt).alive
    assert sched.stats()["failovers"] == f0 + 1
    for node in range(3):
        while sched.node_state(node).active < 2:
            sched.begin("x", node=node)
    n2 = sched.route("s")
    assert sched.node_state(n2).alive


def test_dead_node_is_never_picked_and_rejoins_cold(sched_world):
    _, store = sched_world
    sched = ServeScheduler(store, nodes=range(3))
    sched.offload("s", make_cache())
    n = sched.begin("s")
    sched.end("s", n)
    sched.mark_down(n)
    n2 = sched.route("s")
    assert n2 != n and sched.node_state(n2).alive
    with pytest.raises(SchedulerError):
        sched.begin("s", node=n)
    sched.mark_up(n)
    assert sched.node_state(n).alive
    assert sched.affinity("s", n) == 0.0
    sched.mark_up(9)
    assert sched.node_state(9).alive


def test_no_live_nodes_raises(sched_world):
    _, store = sched_world
    sched = ServeScheduler(store, nodes=range(2))
    sched.offload("s", make_cache())
    sched.mark_down(0)
    sched.mark_down(1)
    with pytest.raises(SchedulerError, match="no live"):
        sched.route("s")


def test_empty_fleet_is_refused(sched_world):
    _, store = sched_world
    with pytest.raises(SchedulerError):
        ServeScheduler(store, nodes=[])


# --------------------------------------------------------- bounded store --
def test_admission_evicts_lru_and_refuses_oversize(sched_world):
    _, store = sched_world
    sched = ServeScheduler(store, nodes=range(2),
                           quota_bytes=3 * SESS_BYTES)
    for i in range(3):
        assert sched.offload(f"s{i}", make_cache(seed=i)) == []
    assert sched.store_bytes == 3 * SESS_BYTES
    n = sched.begin("s0")
    sched.end("s0", n)
    evicted = sched.offload("s3", make_cache(seed=3))
    assert evicted == ["s1"]
    assert "s1" not in store.sessions()
    with pytest.raises(KVStoreError):
        store.manifest("s1")
    assert sched.store_bytes <= 3 * SESS_BYTES
    before = set(store.sessions())
    with pytest.raises(SchedulerError, match="cannot fit"):
        sched.offload("huge", make_cache(seed=9, n_leaves=16))
    assert set(store.sessions()) == before


def test_republish_drops_residency_everywhere(sched_world):
    _, store = sched_world
    sched = ServeScheduler(store, nodes=range(2))
    sched.offload("s", make_cache(seed=0), step=0)
    n = sched.begin("s")
    sched.end("s", n)
    assert sched.affinity("s", n) == 1.0
    sched.offload("s", make_cache(seed=1), step=1)
    assert sched.affinity("s", n) == 0.0
    assert store.step("s") == 1


def test_node_residency_book_is_bounded_by_cache_budget(sched_world):
    _, store = sched_world
    sched = ServeScheduler(store, nodes=[0],
                           node_cache_bytes=2 * SESS_BYTES)
    for i in range(3):
        sched.offload(f"s{i}", make_cache(seed=i))
        sched.begin(f"s{i}", node=0)
        sched.end(f"s{i}", 0)
    ns = sched.node_state(0)
    assert ns.resident_bytes <= 2 * SESS_BYTES
    assert list(ns.resident) == ["s1", "s2"]
    assert sched.affinity("s0", 0) == 0.0


def test_scheduler_adopts_a_live_store(sched_world):
    _, store = sched_world
    store.offload("a", make_cache(seed=0), step=2)
    store.offload("b", make_cache(seed=1), step=5)
    sched = ServeScheduler(store, nodes=range(2))
    assert sched.lru_sessions() == ["a", "b"]
    assert sched.store_bytes == 2 * SESS_BYTES
    st = sched.stats()
    assert st["sessions"] == 2 and st["index_reads"] == 2


def test_seed_skips_torn_index_records(sched_world):
    _, store = sched_world
    store.offload("a", make_cache(seed=0))
    store._sessions_kv().put("ghost", "meta", b"torn")
    sched = ServeScheduler(store, nodes=[0])
    assert sched.lru_sessions() == ["a"]


# -------------------------------------------------------------- churn ----
def test_randomized_churn_conformance(sched_world):
    _, store = sched_world
    rng = np.random.default_rng(7)
    quota = 6 * SESS_BYTES
    sched = ServeScheduler(store, nodes=range(4), max_active=4,
                           quota_bytes=quota)
    live: dict[str, int] = {}
    gone: set[str] = set()
    step = 0
    for _ in range(60):
        op = int(rng.integers(0, 4))
        if op == 0 or not live:
            s = f"s{int(rng.integers(0, 10)):02d}"
            seed = step
            for v in sched.offload(s, make_cache(seed=seed), step=step):
                gone.add(v)
                live.pop(v, None)
            live[s] = seed
            gone.discard(s)
            step += 1
        elif op == 1:
            s = str(rng.choice(sorted(live)))
            n = sched.begin(s)
            got = store.restore(s, client_node=n)
            sched.end(s, n)
            want = make_cache(seed=live[s])
            for k in want:
                assert torch.equal(got[k], want[k])
        elif op == 2:
            s = str(rng.choice(sorted(live)))
            lo = int(rng.integers(0, LEAF_KIB << 10))
            hi = int(rng.integers(lo, (LEAF_KIB << 10) + 1))
            win = store.restore_window(s, lo, hi)
            flat = dict(S.flatten_tree(store.restore(s)))
            for path, arr in win.items():
                np.testing.assert_array_equal(arr, flat[path].numpy()[lo:hi])
        else:
            down = int(rng.integers(0, 4))
            sched.mark_down(down)
            if live:
                s = str(rng.choice(sorted(live)))
                n = sched.route(s)
                assert n != down and sched.node_state(n).alive
            sched.mark_up(down)
        assert sched.store_bytes <= quota
        assert set(store.sessions()) == set(live)
        for v in gone:
            assert v not in store.sessions()
            with pytest.raises(KVStoreError):
                store.session_meta(v)
    st = sched.stats()
    assert st["evictions"] >= 1
    assert st["sessions"] == len(live)


# ---------------------------------------------- speculative prefetch --
def _serve_world():
    pool = Pool(Topology(n_server_nodes=4, engines_per_node=2,
                         n_client_nodes=8, procs_per_client_node=1),
                materialize=True)
    cont = pool.create_container("serve", oclass="SX")
    dfs = DFS(cont, dir_oclass="S1")
    store = KVCacheStore(dfs, interface="posix-cached:timeout=1.0,"
                                        "readahead=4,page_kib=64",
                         n_writers=4, verify_on_restore=False, device="cpu")
    rng = np.random.default_rng(7)
    cache = {f"layer{i:02d}": torch.from_numpy(
        rng.integers(0, 255, (64 << 10,), dtype=np.uint8)) for i in range(8)}
    store.offload("sess", cache, step=0)
    return pool, store, cache


def test_speculation_issues_background_debt_and_warms_node():
    pool, store, cache = _serve_world()
    win = 16 << 10
    sched = ServeScheduler(store, nodes=range(4), speculate_window=win)
    with pool.sim.phase():
        node = sched.begin("sess")
    assert pool.sim.bg_stats["issued_s"] > 0
    st = sched.stats()
    assert st["speculations"] == 1
    assert st["spec_bytes"] > 0
    pool.sim.clock.advance(0.05)
    assert pool.sim._bg_debt == 0.0

    leaf = 64 << 10
    with pool.sim.phase() as fg:
        out = store.restore_window("sess", leaf - win, leaf,
                                   client_node=node)
    pool2, store2, _ = _serve_world()
    sched2 = ServeScheduler(store2, nodes=range(4))
    with pool2.sim.phase():
        node2 = sched2.begin("sess")
    assert sched2.stats()["speculations"] == 0
    with pool2.sim.phase() as fg2:
        out2 = store2.restore_window("sess", leaf - win, leaf,
                                     client_node=node2)
    for k in out:
        np.testing.assert_array_equal(out[k], out2[k])
        np.testing.assert_array_equal(
            out[k], cache[k.lstrip("/")].numpy()[leaf - win: leaf])
    assert fg.elapsed < fg2.elapsed


def test_speculation_skips_fully_warm_node():
    pool, store, cache = _serve_world()
    sched = ServeScheduler(store, nodes=range(4),
                           speculate_window=16 << 10)
    meta = store.session_meta("sess")
    with pool.sim.phase():
        node = sched.begin("sess")
    sched.end("sess", node, nbytes=meta["nbytes"])
    before = sched.stats()["speculations"]
    with pool.sim.phase():
        n2 = sched.begin("sess")
    assert n2 == node
    assert sched.stats()["speculations"] == before


def test_speculation_disabled_by_default():
    pool, store, _ = _serve_world()
    sched = ServeScheduler(store, nodes=range(4))
    with pool.sim.phase():
        sched.begin("sess")
    assert pool.sim.bg_stats["issued_s"] == 0.0
    assert sched.stats()["speculations"] == 0


def test_speculation_never_warms_a_dead_node():
    pool = Pool(Topology(n_server_nodes=4, engines_per_node=2,
                         n_client_nodes=2))
    dfs = DFS(pool.create_container("sv", oclass="RP_2G1"))
    dfs.mkdir("/kv")
    store = KVCacheStore(dfs, interface="posix-cached",
                         verify_on_restore=False, device="cpu")
    sched = ServeScheduler(store, nodes=range(4), speculate_window=1 << 10)
    rng = np.random.default_rng(5)
    sched.offload("s", {"l0": torch.from_numpy(
        rng.integers(0, 255, (4 << 10,), np.uint8))})
    n = sched.begin("s")
    sched.end("s", n)
    sched.speculated_manifest("s", n)
    spec0 = sched.stats()["speculations"]
    sched.mark_down(n)
    n2 = sched.route("s")
    assert n2 != n
    assert sched.speculated_manifest("s", n) is None
    if sched.stats()["speculations"] > spec0:
        assert sched.speculated_manifest("s", n2) is not None


# ------------------------------------------------- tiering: the scheduler --
def _tree(n_leaves=4, leaf_kib=64, seed=0):
    rng = np.random.default_rng(seed)
    return {f"layer{i:03d}": torch.from_numpy(
        rng.integers(0, 255, (leaf_kib << 10,), dtype=np.uint8))
        for i in range(n_leaves)}


def _tiered_store(dfs):
    iface = make_interface("tiered://hot=dfs,cold=cold", dfs)
    return KVCacheStore(dfs, interface=iface, n_writers=2,
                        device="cpu"), iface


def test_scheduler_demote_on_evict_requires_tiered(world):
    _pool, dfs = world
    store = KVCacheStore(dfs, interface="dfs", device="cpu")
    with pytest.raises(SchedulerError, match="tiered://"):
        ServeScheduler(store, nodes=[1], demote_on_evict=True)


def test_scheduler_demotes_instead_of_deleting(world):
    pool, dfs = world
    store, iface = _tiered_store(dfs)
    trees = {f"s{i}": _tree(seed=i) for i in range(3)}
    nbytes = sum(v.numel() for v in trees["s0"].values())
    sched = ServeScheduler(store, nodes=[1, 2], quota_bytes=2 * nbytes)
    assert sched.demote_on_evict
    for s, tree in trees.items():
        sched.offload(s, tree, step=0)
    st = sched.stats()
    assert st["demotions"] == 1 and st["evictions"] == 0
    assert st["cold_sessions"] == 1 and st["sessions"] == 2
    assert sched.store_bytes <= 2 * nbytes
    assert store.tier("s0") == "cold"
    node = sched.begin("s0")
    back = store.restore("s0", client_node=node)
    for k, v in trees["s0"].items():
        assert torch.equal(back[k], v)
    sched.end("s0", node, nbytes=nbytes)
    st = sched.stats()
    assert st["promotions"] == 1 and st["demotions"] == 2
    assert store.tier("s0") == "hot" and store.tier("s1") == "cold"
    assert sched.store_bytes <= 2 * nbytes


def test_scheduler_seeds_cold_sessions_from_index(world):
    pool, dfs = world
    store, _iface = _tiered_store(dfs)
    store.offload("a", _tree(seed=1), step=0)
    store.offload("b", _tree(seed=2), step=0)
    store.demote("a")
    sched = ServeScheduler(store, nodes=[1])
    st = sched.stats()
    assert st["cold_sessions"] == 1 and st["sessions"] == 1
    assert "a" not in sched.lru_sessions()
    node = sched.begin("a")
    assert store.tier("a") == "hot"
    sched.end("a", node)
    assert sched.stats()["promotions"] == 1

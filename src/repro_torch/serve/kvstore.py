"""Session-oriented KV-cache store: the serving tier on the cached I/O
pipeline.

Inference serving is the paper's fine-grained-I/O regime embodied: a
prefill writer publishes a session's KV cache as many small leaves, and a
fleet of decode readers re-reads them every token step — single writer,
many readers, small repeated accesses.  Exactly where interface choice and
client caching dominate (arXiv 2409.18682), and exactly the traffic shape
the coherence layer's single-writer/many-reader guarantees are for.

Like the checkpoint stack, the store holds no raw per-call I/O context —
every byte moves through ``AccessInterface``/``FileHandle`` on whatever
mount string the deployment chose (``dfs``, ``posix-cached:timeout=0.5``,
``daos-array``, ...), so the whole interface/cache/coherence matrix is a
live tuning surface for the serving tier.

Layout of one session:

* leaves       — one file per pytree leaf, ``{base}/{session}{path}.leaf``,
                 placed across client nodes by the interface's
                 topology-derived ``place_writer`` (leaf ``i`` is written
                 by rank ``i % n_writers``);
* manifest     — a 3-way-replicated KV object per session (leaf table:
                 file, nbytes, checksum, writer rank, dtype/shape; plus
                 the pytree skeleton and the published ``step``), written
                 LAST inside the same epoch transaction as the leaves;
* session index — one KV record per session under the store base, written
                 in the same transaction, so namespace-less interfaces
                 (``daos-array``) can still discover and GC sessions.  The
                 record carries ``{step, nbytes, n_leaves}`` so a scheduler
                 routing thousands of sessions reads ONE small KV per
                 decision instead of re-reading every manifest (the index
                 is a cache; the manifest stays the source of truth and
                 ``session_meta`` falls back to — and repairs from — it
                 when the record is stale or unreadable).

The transaction is the torn-snapshot guard: the container's commit barrier
flushes any write-back data staged under the tx *before* the manifest
becomes visible, and an abort punches the staged epoch — so a writer that
dies mid-offload leaves the previous snapshot of the session intact and
restorable, never a half-published one.

``restore`` defaults to reading every leaf on the node that wrote it (a
hot just-offloaded session restores from warm page caches); a decode
reader passes its own ``client_node`` instead, pulling every leaf through
that node's cache tier — the many-reader re-read regime the serve
benchmark measures.

The port's copy of the JAX package's store (serve/kvstore.py), with the
leaves as tensors.  The store binds a device when it is built (the CUDA
card unless ``device="cpu"``), and three things differ:

* ``offload`` takes every CUDA leaf's checksum on the card, with the
  checksum kernel, before any of its bytes leave the card; host leaves
  are checksummed on their bytes.  The leaf bytes and metadata are the
  port serializer's, so the manifest and the stored bytes are the JAX
  store's, and the interface calls come in the JAX store's order, so
  the simulated cost is the same;
* ``restore`` places every leaf on the store's device and, on the card,
  verifies it there with the kernel after the copy (there is no host
  fallback); on the CPU it verifies the host bytes;
* ``timings`` records, per offload, the seconds in the checksums, in the
  copies off the card and in the store, and per restore, in the store
  reads, the copies onto the device and the verification.  Nothing
  depends on it.
"""
from __future__ import annotations

import json
import time

import numpy as np

from ..core import NotFoundError
from ..core.interfaces import AccessInterface, DFS, make_interface
from ..core.multipart import MP_THRESHOLD, multipart_read, should_multipart
from ..ckpt import serializer as S
from ..device import resolve_device


class KVStoreError(IOError):
    pass


def _skeleton(tree) -> dict:
    """JSON-able shape of a pytree (container kinds only), stored in the
    manifest so ``restore(session)`` needs no caller-side template."""
    if isinstance(tree, dict):
        return {"kind": "dict",
                "children": {k: _skeleton(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"kind": "tuple" if isinstance(tree, tuple) else "list",
                "children": [_skeleton(v) for v in tree]}
    return {"kind": "leaf"}


def _template(skel: dict):
    kind = skel["kind"]
    if kind == "dict":
        return {k: _template(v) for k, v in skel["children"].items()}
    if kind in ("list", "tuple"):
        vals = [_template(v) for v in skel["children"]]
        return tuple(vals) if kind == "tuple" else vals
    return None


class KVCacheStore:
    def __init__(self, dfs: DFS, interface: str | AccessInterface = "dfs",
                 oclass: str | None = None, base: str = "/kvcache",
                 n_writers: int = 8,
                 verify_on_restore: bool = True,
                 multipart: bool = True,
                 mp_threshold: int = MP_THRESHOLD,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.dfs = dfs
        self.iface = (interface if isinstance(interface, AccessInterface)
                      else make_interface(interface, dfs))
        self.oclass = oclass or dfs.default_oclass
        self.base = base.rstrip("/")
        self.n_writers = max(1, n_writers)
        # hot-restore multipart: leaves at/above mp_threshold fan across
        # the writer placement as concurrent parts (ordered reassembly);
        # serving-size leaves (well under the threshold) are untouched
        self.multipart = bool(multipart)
        self.mp_threshold = int(mp_threshold)
        # serving tolerates bounded staleness by design: a reader mount on
        # a timeout lease may see the previous step's bytes for up to tau,
        # which the manifest's (always-fresh) checksums would flag — so
        # reader-fleet stores run with verification off and rely on the
        # coherence layer's staleness bound instead
        self.verify = verify_on_restore
        self.timings: list[dict] = []
        try:
            self.iface.mkdir(self.base)
        except Exception:
            pass

    # ------------- paths / manifests -------------
    def _sess_dir(self, session: str) -> str:
        return f"{self.base}/{session}"

    def _manifest_kv(self, session: str):
        # manifests are tiny and precious: always 3-way replicated
        return self.dfs.cont.open_kv(
            f"kvsession:{self._sess_dir(session)}", oclass="RP_3GX")

    def _sessions_kv(self):
        """Session index for discovery/GC — the only enumeration that
        works on namespace-less interfaces (daos-array)."""
        return self.dfs.cont.open_kv(f"kvsessions:{self.base}",
                                     oclass="RP_3GX")

    def manifest(self, session: str) -> dict:
        try:
            raw = self._manifest_kv(session).get("manifest", "json")
        except (NotFoundError, KeyError) as e:
            raise KVStoreError(f"no manifest for session {session!r}") from e
        return S.manifest_loads(bytes(raw))

    def step(self, session: str) -> int:
        """The last published step of a session (manifest-recorded)."""
        return int(self.manifest(session)["step"])

    def sessions(self) -> list[str]:
        """Published sessions.  The index KV is the source of truth: it is
        written inside each offload's transaction, so a torn offload never
        lists (the session *directory* may predate the tx, but directories
        are not publications) — and it is the only enumeration that exists
        on namespace-less interfaces."""
        try:
            return sorted(str(d) for d in self._sessions_kv().list_dkeys())
        except Exception:
            return []

    def nbytes(self, session: str) -> int:
        """Total leaf payload of a session's published snapshot."""
        man = self.manifest(session)
        return sum(int(e["nbytes"]) for e in man["leaves"].values())

    @staticmethod
    def _meta_record(step: int, entries: dict, tier: str = "hot") -> bytes:
        return json.dumps(
            {"step": int(step),
             "nbytes": sum(int(e["nbytes"]) for e in entries.values()),
             "n_leaves": len(entries), "tier": str(tier)},
            sort_keys=True).encode()

    def session_meta(self, session: str) -> dict:
        """``{step, nbytes, n_leaves}`` from the session-index record — one
        small KV read, the O(1) scheduler decision path.  A stale or
        unreadable record (a pre-schema store, a torn index write) falls
        back to the manifest and repairs the index in passing; only a
        missing manifest raises."""
        try:
            raw = bytes(self._sessions_kv().get(str(session), "meta"))
            meta = json.loads(raw)
            return {"step": int(meta["step"]), "nbytes": int(meta["nbytes"]),
                    "n_leaves": int(meta["n_leaves"]),
                    "tier": str(meta.get("tier", "hot"))}
        except (NotFoundError, KeyError, ValueError, TypeError):
            pass
        man = self.manifest(session)        # raises KVStoreError if gone
        entries = man["leaves"]
        tier = str(man.get("tier", "hot"))
        meta = {"step": int(man["step"]),
                "nbytes": sum(int(e["nbytes"]) for e in entries.values()),
                "n_leaves": len(entries), "tier": tier}
        try:                                # repair the index in passing
            self._sessions_kv().put(str(session), "meta",
                                    self._meta_record(meta["step"], entries,
                                                      tier=tier))
        except Exception:
            pass
        return meta

    # ------------- offload -------------
    def offload(self, session: str, cache, step: int = 0,
                extra_meta: dict | None = None) -> dict:
        """Publish one session's KV cache as an atomic snapshot.

        Re-offloading an existing session (a new ``step``) overwrites its
        leaves in place — through the object layer, so attached reader
        caches hear about every update via their coherence policy.  The
        store snapshots each leaf's bytes as it queues them: the caller
        may update the cache in place as soon as this returns."""
        cont = self.dfs.cont
        sdir = self._sess_dir(session)
        try:
            self.iface.mkdir(sdir)
        except Exception:
            pass
        try:        # previous snapshot's leaf set, for post-commit GC
            prior_files = {e["file"] for e in
                           self.manifest(session)["leaves"].values()}
        except KVStoreError:
            prior_files = set()
        t0 = time.perf_counter()
        # (path, leaf, checksum or None): every CUDA leaf's checksum is
        # taken on the card before any of its bytes leave it
        leaves = [(path, leaf, S.card_checksum(leaf))
                  for path, leaf in S.flatten_tree(cache)]
        t = {"checksum_s": time.perf_counter() - t0, "to_host_s": 0.0}
        entries: dict = {}
        tx = cont.tx_begin()
        try:
            for i, (path, leaf, csum) in enumerate(leaves):
                ta = time.perf_counter()
                raw, meta = S.leaf_to_bytes(leaf)
                tb = time.perf_counter()
                if csum is None:
                    csum = S.checksum_leaf(raw)
                t["to_host_s"] += tb - ta
                t["checksum_s"] += time.perf_counter() - tb
                writer = i % self.n_writers
                node, proc = self.iface.place_writer(writer)
                h = self.iface.create(f"{sdir}{path}.leaf",
                                      oclass=self.oclass, client_node=node,
                                      process=proc, tx=tx)
                # async data path: leaf writes queue on the handle's
                # submission window; the tx commit barrier drains them
                h.write_at_async(0, raw)
                entries[path] = {**meta, "csum": csum,
                                 "file": f"{sdir}{path}.leaf",
                                 "nbytes": int(raw.size), "writer": writer}
            manifest = S.manifest_dumps(entries, {
                "session": str(session), "step": int(step),
                "n_writers": self.n_writers, "skeleton": _skeleton(cache),
                "tier": "hot", **(extra_meta or {})})
            # metadata rides the pipelined KV plane: manifest + index
            # records queue on one batch window (the interface's qd) and
            # the commit barrier below drains it with the data queues
            node0, proc0 = self.iface.place_writer(0)
            kvb = self.iface.kv_batch(self._manifest_kv(session), tx=tx,
                                      client_node=node0, process=proc0)
            kvb.put("manifest", "json", manifest)
            # the scheduler's O(1) decision record: size + published step
            # ride the same tx as the manifest, so the index can never
            # list a torn publish (and never lags a committed one)
            kvb.put(str(session), "meta", self._meta_record(step, entries),
                    obj=self._sessions_kv())
            # commit barrier: write-back data staged under this tx reaches
            # the engines BEFORE the manifest becomes visible — a torn
            # offload can never be restored
            tx.commit()
        except BaseException:
            tx.abort()
            raise
        # a republish with a smaller pytree strands the previous
        # snapshot's extra leaves: the new manifest no longer names them,
        # so evict's manifest-driven sweep — the only one that exists on
        # namespace-less interfaces — would never collect them.  GC them
        # now, AFTER the commit (an abort above must leave them live:
        # they still belong to the restorable prior snapshot).
        stale = prior_files - {e["file"] for e in entries.values()}
        for f in sorted(stale):
            try:
                self.iface.unlink(f)
            except (FileNotFoundError, KeyError):
                pass
        t["store_s"] = (time.perf_counter() - t0 - t["checksum_s"]
                        - t["to_host_s"])
        self.timings.append({"op": "offload", "session": str(session),
                             "step": int(step), **t})
        return {"session": str(session), "step": int(step),
                "leaves": entries}

    # ------------- restore -------------
    def _open_leaf(self, entry: dict, client_node: int | None,
                   process: int | None):
        """Open one leaf where its reader runs: the writer's node when no
        ``client_node`` is given (hot restore, warm page caches), else the
        caller's node/process (decode reader, its own cache tier)."""
        if client_node is None:
            node, proc = self.iface.place_writer(entry["writer"])
        else:
            node = client_node
            proc = client_node if process is None else process
        return self.iface.open(entry["file"], client_node=node, process=proc)

    def restore(self, session: str, client_node: int | None = None,
                process: int | None = None, man: dict | None = None):
        """Rebuild a session's cache pytree from its published snapshot.

        ``client_node=None`` reads each leaf on the node that wrote it
        (hot-session restore: warm page caches).  A decode reader passes
        its own node: every leaf then flows through that node's cache.
        A node serving a resident session memoizes its manifest and passes
        it as ``man`` — the session index's ``step`` (one small KV via
        ``session_meta``) says when the memo went stale — so the steady
        decode path pays leaf reads, not a manifest walk per step.
        A demoted session promotes back to the hot tier first (through
        the async data path), transparently.

        Every leaf lands on the store's device.  On the card it is
        verified there by the checksum kernel after the copy; on the CPU
        its host bytes are verified and the tensor shares them."""
        man = self._hot_manifest(session, man)
        on_card = self.device.type == "cuda"
        items: dict = {}
        t = {"read_s": 0.0, "to_device_s": 0.0, "checksum_s": 0.0}
        for path, entry in man["leaves"].items():
            t0 = time.perf_counter()
            if (client_node is None and self.multipart
                    and should_multipart(entry["nbytes"], self.mp_threshold)):
                # hot-restore of a big leaf: fan it across the writer
                # placement as concurrent parts instead of one stream
                raw = multipart_read(self.iface, entry["file"],
                                     int(entry["nbytes"]))
            else:
                h = self._open_leaf(entry, client_node, process)
                raw = np.asarray(h.read_at(0, entry["nbytes"]))
            t1 = time.perf_counter()
            leaf = S.bytes_to_leaf(raw, entry, self.device)
            t2 = time.perf_counter()
            if self.verify:
                got = S.checksum_leaf(leaf if on_card else raw)
                if got != entry["csum"]:
                    raise KVStoreError(
                        f"checksum mismatch for {session!r}{path}: "
                        f"{got:#x} != {entry['csum']:#x}")
            t3 = time.perf_counter()
            items[path] = leaf
            t["read_s"] += t1 - t0
            t["to_device_s"] += t2 - t1
            t["checksum_s"] += t3 - t2
        self.timings.append({"op": "restore", "session": str(session), **t})
        return S.unflatten_tree(items, _template(man["skeleton"]))

    # ------------- paged partial restore -------------
    def restore_slice(self, session: str, path: str, lo: int, hi: int,
                      client_node: int | None = None,
                      process: int | None = None,
                      man: dict | None = None) -> np.ndarray:
        """Bytes ``[lo, hi)`` of ONE leaf, clipped to the leaf, as a host
        ``uint8`` array (a byte range, not a leaf: nothing moves to the
        store's device) — the paged analogue of
        ``Checkpointer.restore_slice`` for the decode path.
        The range read queues on the handle's async submission window;
        hot-path windows at/above the multipart threshold fan across the
        writer placement as ordered parts.  A partial range cannot be
        checked against the manifest's whole-leaf checksum, so slices skip
        verification and rely on the coherence layer's staleness bound —
        the same contract fleet readers already run under.  A caller
        slicing many leaves loads the manifest once and passes ``man``."""
        man = self._hot_manifest(session, man)
        entry = man["leaves"][path]
        lo = max(0, int(lo))
        hi = min(int(entry["nbytes"]), int(hi))
        if hi <= lo:
            return np.zeros(0, np.uint8)
        if (client_node is None and self.multipart
                and should_multipart(hi - lo, self.mp_threshold)):
            return multipart_read(self.iface, entry["file"], hi - lo,
                                  offset=lo)
        h = self._open_leaf(entry, client_node, process)
        return np.asarray(h.read_at_async(lo, hi - lo).wait())

    def restore_window(self, session: str, lo: int, hi: int,
                       client_node: int | None = None,
                       process: int | None = None,
                       man: dict | None = None) -> dict:
        """The decode-step window: bytes ``[lo, hi)`` of EVERY leaf (the
        recent-token tail of each layer's K/V block), returned as
        ``{leaf path: uint8 array}`` of host bytes (byte ranges, not
        leaves: nothing moves to the store's device).  All range reads
        are issued on their handles' submission queues before any is
        awaited, so the window pipelines across leaves and engines
        instead of fetching leaf by leaf — this is what makes a 64 KiB
        decode window cheap against a full-session restore."""
        man = self._hot_manifest(session, man)
        out: dict = {}
        pending: list = []
        for path in sorted(man["leaves"]):
            entry = man["leaves"][path]
            a = max(0, int(lo))
            b = min(int(entry["nbytes"]), int(hi))
            if b <= a:
                out[path] = np.zeros(0, np.uint8)
                continue
            if (client_node is None and self.multipart
                    and should_multipart(b - a, self.mp_threshold)):
                out[path] = multipart_read(self.iface, entry["file"], b - a,
                                           offset=a)
                continue
            h = self._open_leaf(entry, client_node, process)
            pending.append((path, h.read_at_async(a, b - a)))
        for path, ev in pending:
            out[path] = np.asarray(ev.wait())
        return out

    # ------------- tiering (demote / promote) -------------
    def _require_tiered(self, verb: str) -> None:
        if not getattr(self.iface, "tier_aware", False):
            raise KVStoreError(
                f"cannot {verb}: mount {type(self.iface).__name__} has no "
                "cold tier (use a tiered:// mount)")

    def tier(self, session: str) -> str:
        """Which tier holds a session's leaves: ``hot`` or ``cold``
        (manifest-recorded; pre-tiering manifests are hot)."""
        return str(self.manifest(session).get("tier", "hot"))

    def _hot_manifest(self, session: str, man: dict | None) -> dict:
        """The restore paths' entry hook: promote a demoted session before
        touching its leaves, and return a manifest whose ``file`` entries
        are live on the hot tier."""
        if man is None:
            man = self.manifest(session)
        if man.get("tier", "hot") == "cold":
            return self.promote(session)
        return man

    def demote(self, session: str, _fail_after: int | None = None) -> dict:
        """Move one session's leaves to the cold tier.

        Ordering is the T3 contract: leaf bytes are *copied* cold first
        (the cold store is non-transactional), then the manifest's
        ``tier`` field and the session-index record flip inside one epoch
        tx, and the hot copies are unlinked only after the commit
        barrier.  A crash anywhere before the commit leaves the manifest
        pointing hot with every hot leaf intact — a torn demotion wastes
        some cold capacity, it never strands the only copy.

        ``_fail_after=N`` is the fault hook the conformance test uses:
        raise after ``N`` leaf copies, before the manifest flip."""
        self._require_tiered("demote session")
        man = self.manifest(session)
        if man.get("tier", "hot") == "cold":
            return man
        entries = man["leaves"]
        copied = 0
        for path in sorted(entries):
            if _fail_after is not None and copied >= _fail_after:
                raise KVStoreError(
                    f"injected demotion fault after {copied} leaf copies")
            e = entries[path]
            self.iface.demote_file(e["file"], int(e["nbytes"]))
            copied += 1
        extra = {k: v for k, v in man.items() if k != "leaves"}
        extra["tier"] = "cold"
        manifest = S.manifest_dumps(entries, extra)
        tx = self.dfs.cont.tx_begin()
        try:
            node0, proc0 = self.iface.place_writer(0)
            kvb = self.iface.kv_batch(self._manifest_kv(session), tx=tx,
                                      client_node=node0, process=proc0)
            kvb.put("manifest", "json", manifest)
            kvb.put(str(session), "meta",
                    self._meta_record(man["step"], entries, tier="cold"),
                    obj=self._sessions_kv())
            tx.commit()
        except BaseException:
            tx.abort()
            raise
        # hot copies die only after the flip is visible
        for path in sorted(entries):
            self.iface.hot_unlink(entries[path]["file"])
        self.iface.hot_unlink(self._sess_dir(session))
        extra["leaves"] = entries
        return extra

    def promote(self, session: str) -> dict:
        """Pull one demoted session back to the hot tier.

        The mirror of :meth:`demote`: hot leaf writes stage under the
        same epoch tx as the manifest flip (the commit barrier drains
        the async queues before the ``tier`` field turns hot), and the
        cold copies are unlinked only post-commit — an aborted promotion
        leaves the cold copy the (only, intact) source of truth."""
        self._require_tiered("promote session")
        man = self.manifest(session)
        if man.get("tier", "hot") != "cold":
            return man
        entries = man["leaves"]
        try:
            self.iface.mkdir(self._sess_dir(session))
        except Exception:
            pass
        extra = {k: v for k, v in man.items() if k != "leaves"}
        extra["tier"] = "hot"
        manifest = S.manifest_dumps(entries, extra)
        tx = self.dfs.cont.tx_begin()
        try:
            for path in sorted(entries):
                e = entries[path]
                self.iface.promote_file(e["file"], int(e["nbytes"]),
                                        oclass=self.oclass, tx=tx)
            node0, proc0 = self.iface.place_writer(0)
            kvb = self.iface.kv_batch(self._manifest_kv(session), tx=tx,
                                      client_node=node0, process=proc0)
            kvb.put("manifest", "json", manifest)
            kvb.put(str(session), "meta",
                    self._meta_record(man["step"], entries, tier="hot"),
                    obj=self._sessions_kv())
            tx.commit()
        except BaseException:
            tx.abort()
            raise
        for path in sorted(entries):
            self.iface.cold_unlink(entries[path]["file"])
        extra["leaves"] = entries
        return extra

    # ------------- lifecycle (gc) -------------
    def evict(self, session: str) -> None:
        """Remove every trace of one session: leaf files (from the
        manifest, so namespace-less interfaces GC too), stray directory
        entries, the manifest KV, the session-index record, and the
        session directory entry itself."""
        sdir = self._sess_dir(session)
        files: list[str] = []
        try:
            man = self.manifest(session)
        except KVStoreError:
            man = None
        if man is not None:
            files.extend(e["file"] for e in man["leaves"].values())
        for f in dict.fromkeys(files):          # dedup, keep order
            try:
                self.iface.unlink(f)
            except (FileNotFoundError, KeyError):
                pass
        try:
            strays = self.iface.readdir(sdir)
        except Exception:
            strays = []
        for name in strays:                     # stray (non-manifest) files
            try:
                self.iface.unlink(f"{sdir}/{name}")
            except (FileNotFoundError, KeyError):
                pass
        # manifest + index removals pipeline on one batch window
        with self.iface.kv_batch(self._manifest_kv(session)) as kvb:
            kvb.remove("manifest")
            kvb.remove(str(session), obj=self._sessions_kv())
        try:
            self.iface.unlink(sdir)             # the session dir entry
        except (FileNotFoundError, KeyError):
            pass

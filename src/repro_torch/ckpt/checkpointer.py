"""Transactional, asynchronous checkpointing on the DAOS-model store.

The interface (dfs / posix / mpiio / hdf5 / daos-array, plus the cached
variants posix-cached / posix-readahead / dfs-cached) and the object class
(S1..SX / RP_* / EC_*) are *configuration*, which turns the paper's entire
benchmark matrix — including the dfuse client-caching axis of the follow-up
paper (arXiv 2409.18682) — into a live tuning surface for checkpoint I/O.
Layouts:

* ``sharded`` — file-per-host-shard (IOR easy): write parallelism scales
  with hosts, no write contention on a single object;
* ``shared``  — one object, hosts write disjoint ranges (IOR hard): the
  layout parallel filesystems choke on and DAOS doesn't (paper claim C5).

Every checkpoint byte moves through ``AccessInterface``/``FileHandle`` —
the same interface -> cache -> planner -> object -> engine pipeline the IOR
harness measures.  Writer ranks are placed on client nodes by the
interface's topology-derived ``place_writer`` (one writer stream per node
before doubling up), so a cached interface engages one ClientCache per
participating node.

Writes run under one epoch transaction: handles are opened with ``tx=`` so
``write_at`` stages under the transaction's epoch, the manifest publishes
last, and the commit flips the epoch — a writer crash mid-save leaves no
visible state.  Under write-back caching the container's commit barrier
flushes every dirty byte staged under the tx *before* the epoch becomes
visible, so torn-save protection holds even when leaves sit in client
buffers.  ``async_save`` runs the whole thing on an event queue so training
continues (compute/IO overlap, the paper's non-blocking I/O feature).

The port's copy of the JAX package's checkpointer (ckpt/checkpointer.py),
with the leaves as tensors.  Three things differ:

* a CUDA leaf's checksum is computed on the card by the checksum kernel,
  on the calling thread, before any of its bytes leave the card; the
  event-queue workers only move bytes and launch no kernel;
* ``async_save`` copies every leaf to the host before it returns (the
  port's optimizer updates params and state in place), and the on-card
  checksums travel with that snapshot;
* ``restore`` places each leaf on its template leaf's device and, on the
  card, verifies its checksum there with the kernel after the copy.

``timings`` records, per save and restore, the seconds spent in the
checksum kernels, in the copies between card and host, and in the store.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..core import EventQueue, IOCtx, NotFoundError
from ..core.multipart import multipart_write_at, should_multipart
from ..core.interfaces import AccessInterface, DFS, make_interface
from . import serializer as S


class CheckpointError(IOError):
    pass


class _SerialChain:
    """Pipelined host-side serialisation via completion-callback chaining
    (ROADMAP async follow-on (d)): leaf ``i``'s serialisation event, on
    completing, submits leaf ``i+1``'s — so while the save loop queues
    shard writes for leaf ``i`` on the data path, leaf ``i+1`` is already
    serialising on the event queue's worker.  ``get(i)`` is the in-order
    consumer; it also (idempotently) submits ``i`` so an out-of-order or
    post-error access never deadlocks.  Runs on its own small queue, NOT
    the checkpointer's save queue: concurrent ``async_save``s could
    occupy every save slot and a nested submit would then wait on itself.
    """

    def __init__(self, eq: EventQueue, leaves: list) -> None:
        self._eq = eq
        self._leaves = leaves
        self._events: dict = {}
        # reentrant: an already-complete event fires its callback on the
        # submitting thread, inside this very lock
        self._lock = threading.RLock()
        self._submit(0)

    def _submit(self, i: int):
        with self._lock:
            if i >= len(self._leaves):
                return None
            if i not in self._events:
                self._events[i] = self._eq.submit(
                    S.leaf_to_bytes, self._leaves[i][1],
                    on_complete=lambda _ev: self._submit(i + 1))
            return self._events[i]

    def get(self, i: int):
        """``(raw, meta)`` of leaf ``i`` (blocks until serialised)."""
        return self._submit(i).wait()


class Checkpointer:
    def __init__(self, dfs: DFS, interface: str | AccessInterface = "dfs",
                 oclass: str | None = None, layout: str = "sharded",
                 n_writers: int = 8, base: str = "/ckpt",
                 verify_on_restore: bool = True,
                 multipart: bool = True) -> None:
        if layout not in ("sharded", "shared"):
            raise ValueError(layout)
        self.dfs = dfs
        self.iface = (interface if isinstance(interface, AccessInterface)
                      else make_interface(interface, dfs))
        self.oclass = oclass or dfs.default_oclass
        self.layout = layout
        self.n_writers = n_writers
        # part-fan for big leaves on shared-file saves; False pins the
        # rank-fan path (the baseline side of the part-fan study)
        self.multipart = multipart
        self.base = base.rstrip("/")
        self.verify = verify_on_restore
        self.eq = EventQueue(depth=4)
        # serialisation pipeline (see _SerialChain).  Each chain keeps at
        # most 2 events in flight (the leaf being consumed + the one
        # serialising ahead) and there are at most eq.depth concurrent
        # async saves plus one blocking one — sized so chain callbacks,
        # which run on this queue's own workers, can never hit its
        # backpressure path (a callback blocking in submit would starve
        # the queue of the worker needed to clear it)
        self._ser_eq = EventQueue(depth=2 * (self.eq.depth + 1))
        self.timings: list[dict] = []
        try:
            self.iface.mkdir(self.base)
        except Exception:
            pass

    # ------------- paths -------------
    def _step_dir(self, step: int) -> str:
        return f"{self.base}/step_{step:08d}"

    def _manifest_kv(self, sdir: str):
        # manifests are tiny and precious: always 3-way replicated
        return self.dfs.cont.open_kv(f"manifest:{sdir}", oclass="RP_3GX")

    def _steps_kv(self):
        """Step index for namespace-less interfaces (daos-array): raw
        objects are unenumerable, so discovery needs its own KV record."""
        return self.dfs.cont.open_kv(f"ckpt-steps:{self.base}",
                                     oclass="RP_3GX")

    @property
    def _indexed(self) -> bool:
        """Whether steps carry a step-index KV record: namespace-less
        mounts have no directory entries at all, and a tiered mount's
        hot entry disappears on demotion — both discover through the
        (tier-agnostic) index instead."""
        return (not self.iface.has_namespace
                or getattr(self.iface, "tier_aware", False))

    # ------------- save -------------
    @staticmethod
    def _card_checksum(leaf) -> int | None:
        """The checksum a leaf carries into the save: a snapshot's own, a
        CUDA tensor's from the kernel (computed here, on the calling
        thread), else None (host bytes are checksummed as they are
        written)."""
        if isinstance(leaf, S.HostLeaf):
            return leaf.csum
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return S.checksum_leaf(leaf)
        return None

    def save(self, step: int, tree, extra_meta: dict | None = None) -> dict:
        """Blocking transactional save. Returns the manifest dict."""
        cont = self.dfs.cont
        sdir = self._step_dir(step)
        try:
            self.iface.mkdir(sdir)
        except Exception:
            pass
        t0 = time.perf_counter()
        # (path, leaf, checksum or None): every CUDA leaf's checksum is
        # taken before the serialisation chain moves any byte off the card
        leaves = [(path, leaf, self._card_checksum(leaf))
                  for path, leaf in S.flatten_tree(tree)]
        t1 = time.perf_counter()
        entries: dict = {}
        tx = cont.tx_begin()
        try:
            if self.layout == "shared":
                self._save_shared(tx, sdir, leaves, entries)
            else:
                self._save_sharded(tx, sdir, leaves, entries)
            manifest = S.manifest_dumps(entries, {
                "step": step, "layout": self.layout,
                "oclass": self.oclass, "n_writers": self.n_writers,
                "tier": "hot", **(extra_meta or {})})
            # metadata rides the pipelined KV plane: manifest + step-index
            # records queue on one batch window under the tx; the commit
            # barrier below drains it exactly as it drains the data queues.
            # Manifests are native libdaos KV objects — reached directly,
            # not through the data mount — so the window gets the native
            # async ctx whatever interface carried the leaves.
            kvb = tx.kv_batch(self._manifest_kv(sdir), ctx=IOCtx(sync=False))
            kvb.put("manifest", "json", manifest)
            if self._indexed:
                # no durable directory entry records this step (none exists
                # on a namespace-less mount; a tiered mount's disappears on
                # demotion): index it in the same tx so crash recovery and
                # reach-back discovery can find it
                kvb.put(f"{step:08d}", "v", b"1", obj=self._steps_kv())
            # commit barrier (container): any write-back data staged under
            # this tx is flushed to the engines BEFORE the epoch — and with
            # it the manifest — becomes visible
            tx.commit()
        except BaseException:
            tx.abort()
            raise
        self.timings.append({"op": "save", "step": step,
                             "checksum_s": t1 - t0,
                             "store_s": time.perf_counter() - t1})
        return {"leaves": entries, "step": step}

    def _save_sharded(self, tx, sdir, leaves, entries) -> None:
        # serialise/flush overlap: leaf i+1 serialises on the chain's
        # worker while leaf i's shard writes queue below
        chain = _SerialChain(self._ser_eq, leaves)
        for i, (path, _leaf, csum) in enumerate(leaves):
            raw, meta = chain.get(i)
            if csum is None:
                csum = S.checksum_leaf(raw)
            ranges = S.shard_ranges(raw.size, self.n_writers)
            shards = []
            for w, (lo, hi) in enumerate(ranges):
                fname = f"{sdir}{path}.shard{w}"
                node, proc = self.iface.place_writer(w)
                h = self.iface.create(fname, oclass=self.oclass,
                                      client_node=node, process=proc, tx=tx)
                # async data path: shard writes queue on the handle's
                # submission queue (depth = the mount's qd); the tx commit
                # barrier drains whatever the window hasn't forced out
                h.write_at_async(0, raw[lo:hi])
                shards.append({"file": fname, "lo": lo, "hi": hi})
            entries[path] = {**meta, "csum": csum, "shards": shards,
                             "nbytes": int(raw.size)}

    def _save_shared(self, tx, sdir, leaves, entries) -> None:
        fname = f"{sdir}/checkpoint.bin"
        h0 = self.iface.create(fname, oclass=self.oclass, tx=tx)
        offset = 0
        chain = _SerialChain(self._ser_eq, leaves)
        for i, (path, _leaf, csum) in enumerate(leaves):
            raw, meta = chain.get(i)
            if csum is None:
                csum = S.checksum_leaf(raw)
            if self.multipart and should_multipart(raw.size):
                # big leaf: fan by fixed-size part (ROADMAP async follow-on
                # (c)) — parallelism scales with the leaf, not the writer
                # count, and parts stay queued until the commit barrier
                multipart_write_at(self.iface, h0, offset, raw, tx=tx)
            else:
                # hosts write disjoint sub-ranges of this leaf's region,
                # each through its own descriptor on the shared file (dup:
                # no extra namespace traffic, per-rank placement + cache)
                for w, (lo, hi) in enumerate(
                        S.shard_ranges(raw.size, self.n_writers)):
                    node, proc = self.iface.place_writer(w)
                    hw = self.iface.dup(h0, client_node=node, process=proc,
                                        tx=tx)
                    hw.write_at_async(offset + lo, raw[lo:hi])
            entries[path] = {**meta, "csum": csum, "file": fname,
                             "offset": offset, "nbytes": int(raw.size)}
            offset += int(raw.size)
            offset = -(-offset // 128) * 128  # align regions

    def async_save(self, step: int, tree, extra_meta: dict | None = None):
        """Non-blocking save on the event queue (daos-style async I/O).
        Leaves are snapshotted to host numpy BEFORE returning, so training
        may mutate params immediately (the port's step updates them in
        place).  CUDA leaves are checksummed on the card first; their
        checksums travel with the snapshot, which the save does not
        checksum again."""
        t0 = time.perf_counter()
        flat = S.flatten_tree(tree)
        csums = [self._card_checksum(v) for _, v in flat]
        t1 = time.perf_counter()
        snapshot = [(p, S.HostLeaf(*S.leaf_to_bytes(v, copy=True), csum=c))
                    for (p, v), c in zip(flat, csums)]
        self.timings.append({"op": "snapshot", "step": step,
                             "checksum_s": t1 - t0,
                             "to_host_s": time.perf_counter() - t1})
        rebuilt = S.unflatten_tree(dict(snapshot),
                                   _template_of(tree))
        return self.eq.submit(self.save, step, rebuilt, extra_meta)

    def drain(self) -> None:
        self.eq.drain()

    # ------------- restore -------------
    def load_manifest(self, step: int) -> dict:
        sdir = self._step_dir(step)
        try:
            raw = self._manifest_kv(sdir).get("manifest", "json")
        except (NotFoundError, KeyError) as e:
            raise CheckpointError(f"no manifest for step {step}") from e
        return S.manifest_loads(bytes(raw))

    def restore(self, step: int, template) -> dict:
        """Restore a full pytree (every host reads everything it needs;
        re-sharding to a different host count is just different ranges).
        A ``keep_n``-demoted step promotes back through the async data
        path first, transparently."""
        man = self._hot_manifest(step)
        devices = {p: v.device if isinstance(v, torch.Tensor)
                   else torch.device("cpu")
                   for p, v in S.flatten_tree(template)}
        items = {}
        t = {"read_s": 0.0, "to_device_s": 0.0, "checksum_s": 0.0}
        for path, entry in man["leaves"].items():
            t0 = time.perf_counter()
            raw = self._read_leaf(entry, n_writers=man.get("n_writers"))
            t1 = time.perf_counter()
            device = devices.get(path, torch.device("cpu"))
            on_card = device.type == "cuda"
            leaf = S.bytes_to_leaf(raw, entry, device) if on_card else None
            t2 = time.perf_counter()
            if self.verify:
                # a leaf bound for the card is verified there, after the
                # copy, by the kernel; a host leaf on its bytes
                got = S.checksum_leaf(leaf if on_card else raw)
                if got != entry["csum"]:
                    raise CheckpointError(
                        f"checksum mismatch for {path}: "
                        f"{got:#x} != {entry['csum']:#x}")
            t3 = time.perf_counter()
            items[path] = leaf if on_card else S.bytes_to_leaf(raw, entry)
            t["read_s"] += t1 - t0
            t["to_device_s"] += t2 - t1
            t["checksum_s"] += t3 - t2
        self.timings.append({"op": "restore", "step": step, **t})
        return S.unflatten_tree(items, template)

    def restore_slice(self, step: int, path: str, lo: int, hi: int,
                      man: dict | None = None) -> np.ndarray:
        """Elastic restore: read one byte range of one leaf (what a new host
        with a different shard assignment reads).  Reader placement maps
        the range onto the nodes the original writers ran on
        (``place_reader``), so re-sharding onto a *different* host count
        still hits the writers' warm caches where ranges overlap.  A host
        slicing many leaves loads the manifest once and passes it as
        ``man`` instead of re-reading the KV per slice."""
        man = self._hot_manifest(step, man)
        entry = man["leaves"][path]
        return self._read_leaf(entry, lo, hi, n_writers=man.get("n_writers"))

    def place_reader(self, entry: dict, lo: int, hi: int,
                     n_writers: int | None = None):
        """Map one byte range of one leaf onto the client topology the way
        its *writers* were placed: yields ``(node, proc, a, b)`` sub-ranges
        of ``[lo, hi)``, each assigned to the node that originally wrote
        it.  For the sharded layout the shard table gives the writer
        ranges; for the shared layout they are re-derived from the saving
        writer count recorded in the manifest.  This is what makes an
        elastic restore (new host count, new shard assignment) land on
        warm caches wherever new and old ranges overlap."""
        nw = n_writers or self.n_writers
        if "file" in entry:   # shared layout: ranges derived, not stored
            ranges = S.shard_ranges(entry["nbytes"], nw)
        else:
            ranges = [(sh["lo"], sh["hi"]) for sh in entry["shards"]]
        for w, (s_lo, s_hi) in enumerate(ranges):
            a, b = max(lo, s_lo), min(hi, s_hi)
            if a >= b:
                continue
            node, proc = self.iface.place_writer(w)
            yield node, proc, a, b

    def _read_leaf(self, entry: dict, lo: int = 0,
                   hi: int | None = None,
                   n_writers: int | None = None) -> np.ndarray:
        hi = entry["nbytes"] if hi is None else hi
        out = np.zeros(hi - lo, np.uint8)
        if "file" in entry:   # shared layout
            # one namespace lookup; every other reader range gets a dup'd
            # descriptor on its own (possibly warm) node — the
            # MPI_File_open pattern, no extra metadata traffic
            h0 = None
            for node, proc, a, b in self.place_reader(entry, lo, hi,
                                                      n_writers):
                if h0 is None:
                    h0 = self.iface.open(entry["file"], client_node=node,
                                         process=proc)
                    h = h0
                else:
                    h = self.iface.dup(h0, client_node=node, process=proc)
                out[a - lo: b - lo] = h.read_at(entry["offset"] + a, b - a)
            return out
        by_shard = {(sh["lo"], sh["hi"]): sh for sh in entry["shards"]}
        for node, proc, a, b in self.place_reader(entry, lo, hi, n_writers):
            # each shard is read where its writer ran: a cached interface
            # restores a just-written checkpoint from the node-local page
            # cache instead of the fabric
            sh = next(s for (s_lo, s_hi), s in by_shard.items()
                      if s_lo <= a < s_hi)
            h = self.iface.open(sh["file"], client_node=node, process=proc)
            out[a - lo: b - lo] = h.read_at(a - sh["lo"], b - a)
        return out

    # ------------- tiering (demote / promote) -------------
    def _require_tiered(self, verb: str) -> None:
        if not getattr(self.iface, "tier_aware", False):
            raise CheckpointError(
                f"cannot {verb}: mount {type(self.iface).__name__} has no "
                "cold tier (use a tiered:// mount)")

    def step_tier(self, step: int) -> str:
        """Which tier holds a step's payload: ``hot`` or ``cold``
        (manifest-recorded; pre-tiering manifests are hot)."""
        return str(self.load_manifest(step).get("tier", "hot"))

    def _hot_manifest(self, step: int, man: dict | None = None) -> dict:
        """The restore paths' entry hook: promote a demoted step before
        touching its payload, returning a manifest whose files are live
        on the hot tier."""
        if man is None:
            man = self.load_manifest(step)
        if man.get("tier", "hot") == "cold":
            return self.promote_step(step)
        return man

    def _step_files(self, man: dict) -> dict[str, int]:
        """``{file: nbytes}`` of a step's payload, deduplicated: the
        shared layout names one file from every leaf entry (its length is
        the furthest region end), the sharded layout one file per
        (leaf, shard)."""
        files: dict[str, int] = {}
        for entry in man["leaves"].values():
            if "file" in entry:
                end = int(entry["offset"]) + int(entry["nbytes"])
                files[entry["file"]] = max(files.get(entry["file"], 0), end)
            else:
                for sh in entry["shards"]:
                    files[sh["file"]] = int(sh["hi"]) - int(sh["lo"])
        return files

    def demote_step(self, step: int, _fail_after: int | None = None) -> dict:
        """Move one step's payload to the cold tier (what ``keep_n`` GC
        does on a tiered mount instead of deleting).

        The T3 ordering: bytes are *copied* cold first (the cold store is
        non-transactional), the manifest's ``tier`` field flips inside an
        epoch tx, and the hot files are unlinked only after the commit
        barrier — a crash anywhere before the commit leaves the manifest
        pointing at the intact hot copy.  The step-index record (the
        namespace-less discovery path) is tier-agnostic and stays put.

        ``_fail_after=N`` is the fault hook the conformance test uses:
        raise after ``N`` file copies, before the manifest flip."""
        self._require_tiered("demote step")
        man = self.load_manifest(step)
        if man.get("tier", "hot") == "cold":
            return man
        sdir = self._step_dir(step)
        files = self._step_files(man)
        copied = 0
        for fname in sorted(files):
            if _fail_after is not None and copied >= _fail_after:
                raise CheckpointError(
                    f"injected demotion fault after {copied} file copies")
            self.iface.demote_file(fname, files[fname])
            copied += 1
        extra = {k: v for k, v in man.items() if k != "leaves"}
        extra["tier"] = "cold"
        manifest = S.manifest_dumps(man["leaves"], extra)
        tx = self.dfs.cont.tx_begin()
        try:
            kvb = tx.kv_batch(self._manifest_kv(sdir), ctx=IOCtx(sync=False))
            kvb.put("manifest", "json", manifest)
            tx.commit()
        except BaseException:
            tx.abort()
            raise
        # hot copies die only after the flip is visible
        for fname in sorted(files):
            self.iface.hot_unlink(fname)
        self.iface.hot_unlink(sdir)
        extra["leaves"] = man["leaves"]
        return extra

    def promote_step(self, step: int) -> dict:
        """Pull one demoted step back onto the hot tier: hot writes stage
        under the same epoch tx as the manifest flip (the commit barrier
        drains the async part queues first), cold copies are unlinked
        post-commit — an aborted promotion leaves the cold copy the
        intact source of truth."""
        self._require_tiered("promote step")
        man = self.load_manifest(step)
        if man.get("tier", "hot") != "cold":
            return man
        sdir = self._step_dir(step)
        try:
            self.iface.mkdir(sdir)
        except Exception:
            pass
        files = self._step_files(man)
        extra = {k: v for k, v in man.items() if k != "leaves"}
        extra["tier"] = "hot"
        manifest = S.manifest_dumps(man["leaves"], extra)
        tx = self.dfs.cont.tx_begin()
        try:
            for fname in sorted(files):
                self.iface.promote_file(fname, files[fname],
                                        oclass=self.oclass, tx=tx)
            kvb = tx.kv_batch(self._manifest_kv(sdir), ctx=IOCtx(sync=False))
            kvb.put("manifest", "json", manifest)
            tx.commit()
        except BaseException:
            tx.abort()
            raise
        for fname in sorted(files):
            self.iface.cold_unlink(fname)
        extra["leaves"] = man["leaves"]
        return extra

    # ------------- lifecycle (gc) -------------
    def list_steps(self) -> list[int]:
        """Steps visible in the checkpoint namespace (or, for namespace-less
        interfaces, the step-index KV), newest first."""
        steps: set[int] = set()
        try:
            names = self.iface.readdir(self.base)
        except Exception:
            names = []
        for n in names:
            if n.startswith("step_"):
                try:
                    steps.add(int(n[5:]))
                except ValueError:
                    pass
        if self._indexed:
            try:
                steps.update(int(d) for d in self._steps_kv().list_dkeys())
            except Exception:
                pass
        return sorted(steps, reverse=True)

    def delete_step(self, step: int) -> None:
        """Remove every trace of one checkpoint: shard/shared files (from
        the manifest, so namespace-less interfaces gc too), stray directory
        entries, the manifest KV object, and the step directory itself."""
        sdir = self._step_dir(step)
        files: list[str] = []
        try:
            man = self.load_manifest(step)
        except CheckpointError:
            man = None
        if man is not None:
            for entry in man["leaves"].values():
                if "file" in entry:
                    files.append(entry["file"])
                else:
                    files.extend(sh["file"] for sh in entry["shards"])
        for f in dict.fromkeys(files):          # dedup, keep order
            try:
                self.iface.unlink(f)
            except (FileNotFoundError, KeyError):
                pass
        try:        # a demoted step's hot directory entry is already gone
            strays = self.iface.readdir(sdir)
        except Exception:
            strays = []
        for name in strays:                     # stray (non-manifest) files
            try:
                self.iface.unlink(f"{sdir}/{name}")
            except (FileNotFoundError, KeyError):
                pass
        self._manifest_kv(sdir).remove("manifest")
        if self._indexed:
            self._steps_kv().remove(f"{step:08d}")
        try:
            self.iface.unlink(sdir)             # the step directory entry
        except (FileNotFoundError, KeyError):
            pass


def _template_of(tree):
    if isinstance(tree, dict):
        return {k: _template_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_template_of(v) for v in tree)
    return None

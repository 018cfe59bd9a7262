"""Common surface for the paper's access mechanisms.

Every interface exposes file create/open/read/write; *what using it costs*
(fuse crossings, sync chains, fragmentation, metadata chatter) is no longer
hand-assembled per interface but declared once in ``COST_PROFILES`` — a
table of ``CostProfile`` rows, one per interface, rendered into ``IOCtx``
per call.  The IOR harness drives all of them through this one surface,
exactly like IOR's ``-a DFS|POSIX|MPIIO|HDF5`` backends.

Interfaces built with ``cache_mode != "none"`` get one dfuse-style
``ClientCache`` per client node; ``FileHandle`` routes its data ops and the
namespace ops (``stat``/``open``) through it.
"""
from __future__ import annotations

import abc
import dataclasses

import numpy as np

from ..cache import ClientCache
from ..coherence import make_policy, normalize_coherence
from ..events import QueuedOp, SubmissionQueue
from ..object import ArrayObject, IOCtx
from ..simnet import AUTO_QD

# Interface-layer transfer granularities (shared by the cost table and the
# interface modules that historically defined them).
FUSE_MAX_TRANSFER = 1 << 20   # FUSE max transfer size (1 MiB)
H5_CHUNK = 1 << 20            # HDF5 default chunk size here
CB_BUFFER_SIZE = 16 << 20     # ROMIO-ish collective-buffering granularity


@dataclasses.dataclass(frozen=True)
class CostProfile:
    """Declarative per-op cost of one access mechanism.

    A row of the interface-cost table: rendered into an ``IOCtx`` per call
    via :meth:`ctx`, with keyword overrides for the few knobs that are
    per-instance (chunk sizes) or per-call (aggregator stream caps).
    """
    lat_per_op: float = 0.0     # interface-added client latency per RPC
    proc_bw_cap: float = 0.0    # per-process stream cap, 0 = none
    op_multiplier: float = 1.0  # extra RPC inflation (metadata chatter)
    via_fuse: bool = False      # routed through the node's dfuse daemon
    sync: bool = True           # synchronous per-op chain
    frag_bytes: int = 0         # transfer fragmentation granularity

    def ctx(self, client_node: int = 0, process: int = 0, **overrides
            ) -> IOCtx:
        kw = dict(lat_per_op=self.lat_per_op, proc_bw_cap=self.proc_bw_cap,
                  op_multiplier=self.op_multiplier, via_fuse=self.via_fuse,
                  sync=self.sync, frag_bytes=self.frag_bytes)
        kw.update(overrides)
        return IOCtx(client_node=client_node, process=process, **kw)


#: The one table of interface costs (the paper's §III mechanisms + the
#: tuned variants).  Calibrated against published DFuse/HDF5 measurements;
#: previously these literals were scattered across five ``make_ctx``
#: implementations.
COST_PROFILES: dict[str, CostProfile] = {
    # native libdaos byte-array API: lowest overhead, async
    "daos-array": CostProfile(lat_per_op=1e-6, sync=False),
    # libdfs user-space API: no kernel crossing, async-capable
    "dfs": CostProfile(lat_per_op=4e-6, sync=False),
    # POSIX through dfuse: VFS+FUSE round trip, sync, 1 MiB fragmentation
    "posix": CostProfile(lat_per_op=55e-6, via_fuse=True, sync=True,
                         frag_bytes=FUSE_MAX_TRANSFER),
    # POSIX with the interception library (libioil): near-DFS data path
    "posix-ioil": CostProfile(lat_per_op=8e-6, sync=True),
    # MPI-IO over dfuse with ROMIO collective buffering
    "mpiio": CostProfile(lat_per_op=55e-6, via_fuse=True, sync=True,
                         frag_bytes=CB_BUFFER_SIZE, op_multiplier=1.1),
    # MPI-IO with the fuse data path intercepted
    "mpiio-direct": CostProfile(lat_per_op=8e-6, sync=True,
                                frag_bytes=CB_BUFFER_SIZE,
                                op_multiplier=1.1),
    # HDF5 over dfuse: chunked sync stream + B-tree/obj-header chatter
    "hdf5": CostProfile(lat_per_op=120e-6, via_fuse=True, sync=True,
                        frag_bytes=H5_CHUNK, proc_bw_cap=0.28e9,
                        op_multiplier=2.5),
    # HDF5 shared-file through its MPI-IO VFD (collective buffering)
    "hdf5-sfp": CostProfile(lat_per_op=70e-6, via_fuse=True, sync=True,
                            frag_bytes=16 << 20, op_multiplier=1.3),
    # cold object store behind the gateway (the ``cold://`` scheme):
    # request/response — sync per-request chain, qd pinned to 1, and the
    # real costs (TTFB, per-connection stream, gateway aggregate) are the
    # HWProfile's cold_* constants charged via ``record_cold``, not flow
    # solver media/RPC terms.  Concurrency comes from multipart fan-out
    # across processes, exactly like S3 multipart.
    "cold": CostProfile(lat_per_op=0.0, sync=True),
}


class FileHandle:
    """An open file: thin view over an ArrayObject with interface costs.

    When the owning interface has a cache tier, every data op is routed
    through the client node's ``ClientCache`` (which absorbs, coalesces or
    forwards it); otherwise ops go straight to the unified object pipeline.

    A handle opened with ``tx=`` is *transaction-aware*: its writes are
    staged under the transaction's epoch (invisible until commit, punched on
    abort) and its reads see the transaction's own writes.  With a cache
    tier the dirty data carries the tx, so write-back flushes — whether
    triggered by the buffer watermark, ``fsync`` or the container's commit
    barrier — land in the same epoch.

    The ``*_async`` variants queue IODs on a per-handle submission queue
    (up to the mount's ``qd=`` in flight per engine) and return events with
    DAOS test/wait semantics.  Synchronous ops, ``fsync`` and ``close`` are
    ordering barriers: they retire the queue first.  Under a transaction
    the queue registers with the tx, so the commit barrier drains it before
    the epoch becomes visible and an abort discards unexecuted IODs.
    """

    def __init__(self, iface: "AccessInterface", obj: ArrayObject,
                 ctx: IOCtx, cache: ClientCache | None = None,
                 tx=None) -> None:
        self.iface = iface
        self.obj = obj
        self.ctx = ctx
        self.cache = cache
        self.tx = tx
        self.offset = 0
        self.closed = False
        self._queue: SubmissionQueue | None = None

    # -- submission queue (async data path) ----------------------------------
    def _subq(self) -> SubmissionQueue:
        if self._queue is None:
            self._queue = SubmissionQueue(qd=self.iface.exec_qd)
            if self.tx is not None:
                self.tx.register_subq(self._queue)
        return self._queue

    def _barrier(self) -> None:
        """Sync ops order after everything already queued."""
        if self._queue is not None and not self._queue._executing:
            self._queue.flush()

    def _touched(self, offset: int, nbytes: int, write: bool) -> set[int]:
        plan = self.obj._planner(self.obj._layout())
        return plan.touched_engines(offset, nbytes, write=write)

    @staticmethod
    def _snapshot(data):
        """Queued writes execute lazily: pin the payload now so the caller
        may reuse its buffer immediately (daos_event semantics)."""
        if isinstance(data, (bytes, bytearray, memoryview)):
            return bytes(data)
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1).copy()

    def write_at_async(self, offset: int, data) -> QueuedOp:
        buf = self._snapshot(data)
        return self._subq().submit(
            lambda: self.write_at(offset, buf),
            self._touched(offset, len(buf), write=True))

    def read_at_async(self, offset: int, size: int) -> QueuedOp:
        return self._subq().submit(
            lambda: self.read_at(offset, size),
            self._touched(offset, size, write=False))

    def write_sized_at_async(self, offset: int, nbytes: int) -> QueuedOp:
        return self._subq().submit(
            lambda: self.write_sized_at(offset, nbytes),
            self._touched(offset, nbytes, write=True))

    def read_sized_at_async(self, offset: int, nbytes: int) -> QueuedOp:
        return self._subq().submit(
            lambda: self.read_sized_at(offset, nbytes),
            self._touched(offset, nbytes, write=False))

    def flush_queue(self) -> None:
        """Retire every queued IOD (submission order); re-raise the first
        queued error."""
        if self._queue is not None:
            self._queue.flush()

    @property
    def queued(self) -> int:
        return self._queue.inflight if self._queue is not None else 0

    # -- explicit-offset ops (what IOR uses) --------------------------------
    def write_at(self, offset: int, data) -> int:
        self._barrier()
        if self.cache is not None:
            return self.cache.write(self.obj, offset, data, self.ctx,
                                    tx=self.tx)
        if self.tx is not None:
            return self.tx.write_array(self.obj, offset, data, ctx=self.ctx)
        return self.obj.write(offset, data, ctx=self.ctx)

    def read_at(self, offset: int, size: int) -> np.ndarray:
        self._barrier()
        if self.cache is not None:
            return self.cache.read(self.obj, offset, size, self.ctx,
                                   tx=self.tx)
        if self.tx is not None:
            return self.tx.read_array(self.obj, offset, size, ctx=self.ctx)
        return self.obj.read(offset, size, ctx=self.ctx)

    def write_sized_at(self, offset: int, nbytes: int) -> int:
        self._barrier()
        if self.cache is not None:
            return self.cache.write_sized(self.obj, offset, nbytes, self.ctx,
                                          tx=self.tx)
        if self.tx is not None:
            return self.tx.write_sized(self.obj, offset, nbytes, ctx=self.ctx)
        return self.obj.write_sized(offset, nbytes, ctx=self.ctx)

    def read_sized_at(self, offset: int, nbytes: int) -> int:
        self._barrier()
        if self.cache is not None:
            return self.cache.read_sized(self.obj, offset, nbytes, self.ctx,
                                         tx=self.tx)
        if self.tx is not None:
            return self.tx.read_sized(self.obj, offset, nbytes, ctx=self.ctx)
        return self.obj.read_sized(offset, nbytes, ctx=self.ctx)

    # -- streaming ops (POSIX style) -----------------------------------------
    def seek(self, offset: int) -> None:
        self.offset = offset

    def write(self, data) -> int:
        n = self.write_at(self.offset, data)
        self.offset += n
        return n

    def read(self, size: int) -> np.ndarray:
        out = self.read_at(self.offset, size)
        self.offset += len(out)
        return out

    def fsync(self) -> None:
        self.flush_queue()
        if self.cache is not None:
            self.cache.flush(self.obj)

    @property
    def size(self) -> int:
        return self.obj.size

    def close(self) -> None:
        self.fsync()    # write-back data becomes durable at close
        self.closed = True


class AccessInterface(abc.ABC):
    """One of the paper's access mechanisms over a DFS namespace."""

    name: str = "?"
    profile_name: str = "dfs"   # row of COST_PROFILES this interface uses
    has_namespace: bool = True  # False: raw objects, mkdir/readdir are void

    def __init__(self, dfs, cache_mode: str = "none", coherence=None,
                 cache_opts: dict | None = None,
                 qd: int | str | None = None) -> None:
        self.dfs = dfs
        # submission-queue depth (the qd= mount option): async IODs in
        # flight per engine for this mount's handles.  None = the hardware
        # profile's default depth; "auto" = the solver picks the window
        # from measured engine congestion.  Synchronous interfaces are
        # pinned to 1 by the `qd` property regardless — a blocking VFS
        # round trip cannot leave more than one RPC in flight — and a
        # sync mount asking for the adaptive window is a contradiction,
        # not a silent pin, so it errors like any malformed option.
        if isinstance(qd, str):
            if qd != "auto":
                raise ValueError(f"qd={qd!r}: submission-queue depth must "
                                 "be an integer >= 1 or 'auto'")
            if self.profile.sync:
                raise ValueError(
                    f"qd=auto requires an asynchronous interface; "
                    f"{type(self).__name__} ({self.profile_name!r}) issues "
                    "blocking per-op round trips, so its window is pinned "
                    "to 1 and there is nothing to adapt")
        elif qd is not None and int(qd) < 1:
            raise ValueError(f"qd={qd!r}: submission-queue depth must "
                             "be >= 1")
        self._mount_qd = qd if isinstance(qd, str) or qd is None else int(qd)
        # coherence: None/str/dict spec (see core.coherence) selected by
        # mount options; "off" means direct I/O — no cache is ever created,
        # so the interface is byte-for-byte its uncached self.
        self.coherence = normalize_coherence(coherence)
        # a mount that never creates a cache has nothing for a coherence
        # policy or cache-geometry knob to act on: silently ignoring the
        # option would let "posix:timeout=1" masquerade as a cached mount
        # (or "posix-cached:coherence=off,readahead=4" as a tuned one),
        # so both are errors — "coherence=off" itself is consistent on
        # any interface (it states what is then true)
        if (cache_mode == "none" and coherence is not None
                and self.coherence["policy"] != "off"):
            raise ValueError(
                f"coherence={self.coherence['policy']!r} requires a "
                f"caching interface (e.g. posix-cached/dfs-cached); "
                f"{type(self).__name__} with cache_mode='none' never "
                "creates a cache")
        if self.coherence["policy"] == "off":
            cache_mode = "none"
        if cache_mode == "none" and cache_opts:
            raise ValueError(
                f"cache options {sorted(cache_opts)} require a caching "
                f"interface; this {type(self).__name__} mount never "
                "creates a cache")
        self.cache_mode = cache_mode
        self.cache_opts = dict(cache_opts or {})
        self._caches: dict[int, ClientCache] = {}

    # ---- cost model --------------------------------------------------------
    @property
    def profile(self) -> CostProfile:
        return COST_PROFILES[self.profile_name]

    @property
    def qd(self) -> int:
        """Effective submission-queue depth of this mount: 1 on sync
        interfaces (pinned — their per-op chain can't pipeline),
        ``AUTO_QD`` (-1) when the mount said ``qd=auto`` (the solver picks
        each (process, engine) window from measured congestion), else the
        ``qd=`` mount option or the hardware profile's default."""
        if self.profile.sync:
            return 1
        if self._mount_qd == "auto":
            return AUTO_QD
        if self._mount_qd is not None:
            return self._mount_qd
        return self.dfs.cont.pool.sim.hw.queue_depth

    @property
    def exec_qd(self) -> int:
        """The positive client-side window a ``SubmissionQueue`` is built
        with: an auto mount queues up to the solver's auto cap (2x the
        hardware default depth) and lets the congestion feedback set the
        charged window; fixed mounts use their depth directly."""
        q = self.qd
        if q == AUTO_QD:
            return 2 * self.dfs.cont.pool.sim.hw.queue_depth
        return q

    def make_ctx(self, client_node: int = 0, process: int = 0,
                 transfer_bytes: int = 0) -> IOCtx:
        """The cost profile of one I/O call through this interface."""
        return self.profile.ctx(client_node, process, qd=self.qd)

    def kv_batch(self, obj, tx=None, client_node: int = 0, process: int = 0,
                 qd: int | None = None):
        """Open a pipelined KV window through this mount's cost profile —
        the metadata-plane analogue of the handles' submission queues, so
        manifest/index records cost what this interface costs and pipeline
        as deep as its ``qd`` allows (window 1 on sync profiles).  With
        ``tx=`` the batch joins the tx's commit/abort barriers."""
        ctx = self.make_ctx(client_node, process)
        if tx is not None:
            return tx.kv_batch(obj, ctx=ctx, qd=qd)
        return obj.batch(ctx=ctx, qd=qd)

    # ---- cache tier --------------------------------------------------------
    def cache_for(self, client_node: int) -> ClientCache | None:
        """This client node's cache (created lazily), or None if uncached."""
        if self.cache_mode == "none":
            return None
        cache = self._caches.get(client_node)
        if cache is None:
            cache = ClientCache(client_node=client_node, mode=self.cache_mode,
                                policy=make_policy(self.coherence),
                                **self.cache_opts)
            self.dfs.cont.attach_cache(cache)
            self._caches[client_node] = cache
        return cache

    def cache_stats(self) -> dict:
        """Aggregate hit/miss/flush stats across this interface's caches."""
        total: dict[str, int] = {}
        for cache in self._caches.values():
            for k, v in cache.stats.as_dict().items():
                total[k] = total.get(k, 0) + v
        return total

    def coherence_stats(self) -> dict:
        """Aggregate coherence traffic/staleness stats across this
        interface's caches (one policy instance per cache)."""
        total: dict = {"policy": self.coherence["policy"]}
        for cache in self._caches.values():
            for k, v in cache.policy.stats.as_dict().items():
                if k == "max_staleness_s":
                    total[k] = max(total.get(k, 0.0), v)
                else:
                    total[k] = total.get(k, 0) + v
        total["messages"] = sum(
            c.policy.stats.messages() for c in self._caches.values())
        return total

    def flush_caches(self) -> None:
        for cache in self._caches.values():
            cache.flush()

    def drop_caches(self) -> None:
        """Simulate remounting every client node: all cached state (pages,
        dentries) is forgotten; pending write-back data is flushed first."""
        for cache in self._caches.values():
            cache.drop_all()

    def _handle(self, obj: ArrayObject, ctx: IOCtx,
                client_node: int, tx=None) -> FileHandle:
        cache = self.cache_for(client_node)
        if cache is not None:
            ctx = dataclasses.replace(ctx, cache=cache)
        return FileHandle(self, obj, ctx, cache, tx=tx)

    # ---- topology-derived placement ----------------------------------------
    def place_writer(self, rank: int) -> tuple[int, int]:
        """Map a parallel-writer rank onto the client topology.

        Checkpoint writers are hosts: rank ``w`` runs on client node
        ``w % n_client_nodes`` (round-robin, one writer stream per node
        before doubling up), keeping every node NIC — and, when caching is
        on, every node's ClientCache — in play."""
        topo = self.dfs.cont.pool.sim.topo
        return rank % topo.n_client_nodes, rank

    def _dentry_vobj(self, path: str):
        """The parent directory's KV object — the version-token anchor a
        timeout policy revalidates this path's dentry against."""
        try:
            parent, _ = self.dfs._split(path)
            return self.dfs._dir_kv(parent)
        except Exception:
            return None

    def _dentry_hit_cost(self, client_node: int, process: int) -> None:
        """A dentry-cache hit is not free: one page-cache/syscall lookup on
        the caller's serial chain (no fabric, no metadata service)."""
        self.dfs.cont.pool.sim.record_local(client_node=client_node,
                                            process=process, nbytes=0,
                                            nops=1)

    # ---- namespace ops -----------------------------------------------------
    def create(self, path: str, oclass=None, client_node: int = 0,
               process: int = 0, tx=None) -> FileHandle:
        ctx = self.make_ctx(client_node, process)
        obj = self.dfs.create_file(path, oclass=oclass, ctx=ctx)
        cache = self.cache_for(client_node)
        if cache is not None:
            ocname = obj.oclass.name
            cache.put_dentry(path, {"type": "file", "oclass": ocname},
                             vobj=self._dentry_vobj(path))
        return self._handle(obj, ctx, client_node, tx=tx)

    def open(self, path: str, client_node: int = 0,
             process: int = 0, tx=None) -> FileHandle:
        ctx = self.make_ctx(client_node, process)
        cache = self.cache_for(client_node)
        if cache is not None:
            d = cache.lookup_dentry(path, process=process)
            if d is not None and d.get("type") == "file":
                # dentry hit: skip the namespace KV walk entirely
                self._dentry_hit_cost(client_node, process)
                obj = self.dfs.cont.open_array(f"file:{path}",
                                               oclass=d["oclass"])
                return self._handle(obj, ctx, client_node, tx=tx)
        obj = self.dfs.open_file(path, ctx=ctx)
        if cache is not None:
            cache.put_dentry(path, {"type": "file",
                                    "oclass": obj.oclass.name},
                             vobj=self._dentry_vobj(path))
        return self._handle(obj, ctx, client_node, tx=tx)

    def dup(self, handle: FileHandle, client_node: int = 0, process: int = 0,
            tx=None) -> FileHandle:
        """A second descriptor on an already-open file for another rank —
        the shared-file (MPI_File_open-style) pattern where every rank holds
        its own fd but only one namespace lookup ever happened.  No
        metadata traffic; the new handle carries the rank's own placement,
        cache tier and transaction."""
        ctx = self.make_ctx(client_node, process)
        return self._handle(handle.obj, ctx, client_node, tx=tx)

    def _unlink_ctx(self, client_node: int, process: int) -> IOCtx:
        """Ctx of an unlink/punch: carries the caller's cache (if one
        already exists — never created for this) so the resulting
        notify_punch doesn't charge the unlinker a revocation of its own
        pages."""
        ctx = self.make_ctx(client_node, process)
        cache = self._caches.get(client_node)
        if cache is not None:
            ctx = dataclasses.replace(ctx, cache=cache)
        return ctx

    def unlink(self, path: str, client_node: int = 0, process: int = 0) -> None:
        # a file unlink punches the object, and the punch fans out through
        # every attached cache's coherence policy FIRST (pages, write-back
        # data and the file's dentry drop there — costed for foreign
        # sharers, dentry-only holders included; free for the unlinker).
        # The local sweep afterwards only mops up what no punch covers:
        # directory dentries (directories have no object to punch).
        self.dfs.unlink(path, ctx=self._unlink_ctx(client_node, process))
        for cache in self._caches.values():
            cache.drop_dentry(path)

    def stat(self, path: str, client_node: int = 0, process: int = 0) -> dict:
        cache = self.cache_for(client_node)
        if cache is not None:
            d = cache.lookup_dentry(path, process=process)
            if d is not None:
                self._dentry_hit_cost(client_node, process)
                if d.get("type") == "file":
                    obj = self.dfs.cont.open_array(f"file:{path}",
                                                   oclass=d["oclass"])
                    d["size"] = obj.size
                return d
        d = self.dfs.stat(path, ctx=self.make_ctx(client_node, process))
        if cache is not None:
            cache.put_dentry(path, {k: v for k, v in d.items()
                                    if k != "size"},
                             vobj=self._dentry_vobj(path))
        return d

    def mkdir(self, path: str) -> None:
        """Directory creation is a pure metadata op (no data-path ctx)."""
        self.dfs.mkdir(path)

    def readdir(self, path: str) -> list[str]:
        return self.dfs.readdir(path)

"""DAOS objects: the byte-array API and the key-value API (libdaos level).

An object is identified by a 64-bit oid and placed on engines by its object
class (``layout.place_object``).  Two access models, mirroring libdaos:

* ``ArrayObject`` — a sparse byte array striped over the object's targets in
  ``stripe_cell``-sized cells (daos_array_*).  Supports replication (RP_k,
  degraded reads) and XOR erasure coding (EC_kP1, reconstruction).
* ``KVObject`` — dkey/akey records; dkeys hash onto shards (daos_kv_* /
  daos_obj_update).

Every data op records its flows into the pool's ``IOSim`` with the caller's
``IOCtx`` (client node / process / interface overheads) — that is how the
IOR harness measures "bandwidth" on a CPU-only container while still moving
the real bytes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import layout as _layout
from . import redundancy
from .engine import Engine, EngineFailedError, NotFoundError
from .events import SubmissionQueue
from .iopath import CellPlanner, FlowAccumulator
from .simnet import AUTO_QD


@dataclasses.dataclass
class IOCtx:
    """Where an I/O call comes from + what the interface layer costs."""
    client_node: int = 0
    process: int = 0
    lat_per_op: float = 0.0     # interface-added client latency per RPC
    proc_bw_cap: float = 0.0    # per-process stream cap (DFuse), 0 = none
    op_multiplier: float = 1.0  # extra RPC inflation (HDF5 metadata chatter)
    via_fuse: bool = False      # routed through the client node's dfuse daemon
    sync: bool = True           # synchronous per-op chain (POSIX-style)
    qd: int = 0                 # async in-flight window per engine (the qd=
                                # mount option); 0 = hardware default depth;
                                # AUTO_QD (-1) = solver-adapted window
    frag_bytes: int = 0         # interface fragments transfers (fuse 1 MiB,
                                # HDF5 chunk size); 0 = no fragmentation
    cache: object | None = None  # originating ClientCache, so the coherence
                                 # broadcast skips the writer's own cache


DEFAULT_CTX = IOCtx()


class _ObjectBase:
    def __init__(self, container, name: str, oid: int,
                 oclass: _layout.ObjectClass, stripe_cell: int) -> None:
        self.container = container
        self.pool = container.pool
        self.name = name
        self.oid = oid
        self.oclass = oclass
        self.stripe_cell = stripe_cell

    # placement with rebuild overrides applied
    def _layout(self) -> _layout.StripeLayout:
        return self.container.layout_for(self.oid, self.oclass,
                                         self.stripe_cell)

    def _engine(self, engine_id: int) -> Engine:
        return self.pool.engines[engine_id]

    def _key(self, dkey, akey) -> tuple:
        return (self.container.label, self.oid, dkey, akey)

    def _record_flows(self, per_engine: dict, direction: str,
                      ctx: IOCtx) -> None:
        for eid, (nbytes, nops, cell) in per_engine.items():
            if ctx.frag_bytes:
                nops = max(nops, -(-nbytes // ctx.frag_bytes))
                cell = min(cell, ctx.frag_bytes)
            self.pool.sim.record(
                client_node=ctx.client_node, process=ctx.process,
                engine=eid, direction=direction, nbytes=nbytes,
                nops=max(1, int(round(nops * ctx.op_multiplier))),
                cell_bytes=cell, client_lat_per_op=ctx.lat_per_op,
                proc_bw_cap=ctx.proc_bw_cap, via_fuse=ctx.via_fuse,
                sync=ctx.sync, qd=ctx.qd)


class ArrayObject(_ObjectBase):
    """daos_array_*: striped byte array with optional RP/EC protection.

    All four data methods share one plan/execute/record pipeline
    (``iopath.CellPlanner`` + ``iopath.FlowAccumulator``); each method only
    supplies the per-span action (move real bytes, or account a sized hole).
    """

    # ---------------- placement helpers ----------------
    def _planner(self, lay: _layout.StripeLayout) -> CellPlanner:
        return CellPlanner(lay, self.oclass, self.stripe_cell)

    def _data_width(self, lay: _layout.StripeLayout) -> int:
        return self._planner(lay).data_width()

    def _cell_engines(self, lay: _layout.StripeLayout, cell_no: int):
        """Engines holding this data cell (replicas) or (data, parity, lane)
        info for EC."""
        return self._planner(lay).cell_engines(cell_no)

    # ---------------- size metadata ----------------
    @property
    def size(self) -> int:
        return self.container.object_size(self.oid)

    def _grow(self, new_end: int) -> None:
        self.container.set_object_size(self.oid,
                                       max(self.size, new_end))

    # ---------------- write ----------------
    def write(self, offset: int, data, epoch: int | None = None,
              ctx: IOCtx = DEFAULT_CTX) -> int:
        """Write bytes at offset. Returns bytes written."""
        buf = np.asarray(
            np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray,
                                                               memoryview))
            else np.ascontiguousarray(data).view(np.uint8).reshape(-1))
        if epoch is None:
            epoch = self.container.auto_epoch()
        lay = self._layout()
        plan = self._planner(lay)
        acc = FlowAccumulator(self.stripe_cell)
        n = buf.size
        pos = 0
        for span in plan.spans(offset, n):
            payload = buf[pos:pos + span.take]
            full = self._rmw_cell(lay, span.cell_no, span.in_cell, payload,
                                  epoch)
            if self.oclass.ec_data:
                self._write_cell_ec(plan, span.cell_no, full, epoch, acc)
            else:
                wrote = 0
                last_err: Exception | None = None
                for eid in plan.replicas(span.cell_no):
                    try:  # degraded write: skip dead replicas (rebuild
                        # restores redundancy later)
                        self._engine(eid).update(
                            self._key("arr", span.cell_no), full, epoch)
                    except EngineFailedError as e:
                        last_err = e
                        continue
                    wrote += 1
                    acc.add(eid, span.take)
                if not wrote:
                    raise redundancy.DataLossError(
                        f"object {self.name}: no live replica for cell "
                        f"{span.cell_no}") from last_err
            pos += span.take
        # one RPC per engine per call batches the cells (DAOS IOD semantics):
        self._record_flows(acc.flows(), "write", ctx)
        self._grow(offset + n)
        self.container.notify_write(self.name, epoch, origin=ctx.cache,
                                    offset=offset, nbytes=n, ctx=ctx)
        return n

    def _rmw_cell(self, lay, cell_no: int, in_cell: int, payload: np.ndarray,
                  epoch: int) -> np.ndarray:
        """Read-modify-write for partial cells (returns the full cell)."""
        cell = self.stripe_cell
        if in_cell == 0 and payload.size == cell:
            return payload
        try:
            old = self._read_cell(lay, cell_no, float(epoch))
        except (NotFoundError, KeyError):
            old = b""
        base = np.zeros(max(in_cell + payload.size, len(old)), np.uint8)
        if old:
            base[: len(old)] = np.frombuffer(old, np.uint8)
        base[in_cell: in_cell + payload.size] = payload
        return base

    def _write_cell_ec(self, plan: CellPlanner, cell_no: int,
                       full: np.ndarray, epoch: int,
                       acc: FlowAccumulator) -> None:
        p = plan.ec_placement(cell_no)
        self._engine(p.data_engine).update(self._key("arr", cell_no), full,
                                           epoch)
        acc.add(p.data_engine, full.size)
        # recompute group parity from the cells present at this epoch
        cells = []
        for ln in range(p.k):
            cn = p.group * p.k + ln
            try:
                cells.append(self._fetch_raw(plan.primary(cn), cn,
                                             float(epoch)))
            except (NotFoundError, KeyError, EngineFailedError):
                pass
        parity = redundancy.xor_parity(cells, self.stripe_cell)
        self._engine(p.parity_engine).update(self._key("par", p.group),
                                             parity, epoch)
        acc.add(p.parity_engine, len(parity))

    # ---------------- read ----------------
    def _fetch_raw(self, eid: int, cell_no: int, max_epoch: float) -> bytes:
        rec = self._engine(eid).fetch(self._key("arr", cell_no), max_epoch)
        return rec.data if rec.data is not None else b"\0" * rec.length

    def _read_cell(self, lay, cell_no: int, max_epoch: float,
                   acc: FlowAccumulator | None = None,
                   take: int | None = None,
                   recon: list | None = None) -> bytes:
        """Fetch one cell, walking the degraded path when engines are down.

        With ``acc`` the fetch fan-out that *actually happened* is charged
        into it — the surviving replica a fallback landed on, or the k-1
        survivor cells + parity an EC reconstruction pulled — instead of the
        caller blindly charging the (possibly dead) primary.  ``take`` is
        the span's byte share on the healthy path; degraded EC fetches are
        whole-cell regardless.  ``recon`` (a mutable list) collects one
        entry per EC reconstruction so the caller can charge the client-side
        XOR pass."""
        charge = self.stripe_cell if take is None else take
        if self.oclass.ec_data:
            data_eng, parity_eng, group, lane, k = self._cell_engines(lay,
                                                                      cell_no)
            try:
                raw = self._fetch_raw(data_eng, cell_no, max_epoch)
            except EngineFailedError:
                return self._reconstruct_ec(lay, cell_no, max_epoch,
                                            acc=acc, recon=recon)
            except NotFoundError:
                if acc is not None:  # the consult RPC still happened
                    acc.add(data_eng, charge)
                raise
            if acc is not None:
                acc.add(data_eng, charge)
            return raw
        last_err: Exception | None = None
        for eid in self._cell_engines(lay, cell_no):
            try:
                raw = self._fetch_raw(eid, cell_no, max_epoch)
            except EngineFailedError as e:
                last_err = e  # degraded read: next replica
                continue
            except NotFoundError:
                if acc is not None:
                    acc.add(eid, charge)
                raise
            if acc is not None:
                acc.add(eid, charge)
            return raw
        if last_err is not None:
            raise redundancy.DataLossError(
                f"object {self.name}: cell {cell_no} unrecoverable "
                f"({self.oclass.name}, all replicas down)") from last_err
        raise NotFoundError((self.oid, cell_no))

    def _reconstruct_ec(self, lay, cell_no: int, max_epoch: float,
                        acc: FlowAccumulator | None = None,
                        recon: list | None = None) -> bytes:
        data_eng, parity_eng, group, lane, k = self._cell_engines(lay, cell_no)
        survivors = []
        lost_len = self.stripe_cell
        for ln in range(k):
            if ln == lane:
                continue
            cn = group * k + ln
            eng = self._cell_engines(lay, cn)[0]
            try:
                raw = self._fetch_raw(eng, cn, max_epoch)
            except (NotFoundError, KeyError):
                continue  # absent cell == zeros, XOR identity
            except EngineFailedError as e:
                raise redundancy.DataLossError(
                    f"object {self.name}: cell {cell_no} unrecoverable "
                    f"(survivor lane {ln} also down — EC_{k}P1 tolerates "
                    "one failure)") from e
            survivors.append(raw)
            if acc is not None:
                acc.add(eng, len(raw))
        try:
            parity_rec = self._engine(parity_eng).fetch(
                self._key("par", group), max_epoch)
        except (EngineFailedError, NotFoundError) as e:
            raise redundancy.DataLossError(
                f"object {self.name}: cell {cell_no} and its parity are both "
                "unavailable") from e
        parity = (parity_rec.data if parity_rec.data is not None
                  else b"\0" * parity_rec.length)
        if acc is not None:
            acc.add(parity_eng, len(parity))
        if recon is not None:
            recon.append(cell_no)
        return redundancy.reconstruct(survivors, parity, self.stripe_cell,
                                      lost_len)

    def _charge_reconstruct(self, plan: CellPlanner, n_recon: int,
                            ctx: IOCtx) -> None:
        """Client-side XOR pass of an EC reconstruction: the k cell images
        stream through client memory once per rebuilt cell."""
        if not n_recon:
            return
        self.pool.sim.record_local(
            client_node=ctx.client_node, process=ctx.process,
            nbytes=n_recon * plan.data_width() * self.stripe_cell,
            nops=n_recon)

    def read(self, offset: int, size: int, epoch: float | None = None,
             ctx: IOCtx = DEFAULT_CTX) -> np.ndarray:
        """Read bytes [offset, offset+size) visible at the snapshot epoch.

        Degraded reads are costed inline: a dead primary's span is charged
        to the surviving replica that actually served it, and an EC
        reconstruction charges the k-1 survivor fetches + the parity fetch
        + a client-local XOR pass.  Unprotected classes raise
        ``DataLossError`` honestly."""
        if epoch is None:
            epoch = float(self.container.committed_epoch)
        lay = self._layout()
        plan = self._planner(lay)
        acc = FlowAccumulator(self.stripe_cell)
        out = np.zeros(size, np.uint8)
        recon: list = []
        pos = 0
        for span in plan.spans(offset, size):
            try:
                raw = self._read_cell(lay, span.cell_no, epoch, acc=acc,
                                      take=span.take, recon=recon)
                chunk = np.frombuffer(raw, np.uint8)
                avail = chunk[span.in_cell: span.end]
                out[pos: pos + avail.size] = avail
            except (NotFoundError, KeyError):
                pass  # sparse hole reads as zeros (consult RPC charged)
            pos += span.take
        self._record_flows(acc.flows(), "read", ctx)
        self._charge_reconstruct(plan, len(recon), ctx)
        return out

    # ---------------- sized (synthetic-payload) I/O ----------------
    # The IOR sweeps move hundreds of GiB of *hypothetical* data; these paths
    # perform full placement + flow accounting + hole-record bookkeeping
    # without ever constructing the payload (Engine stores length-only
    # records). Correctness paths (checkpoints, DFS tests) use write()/read().
    def write_sized(self, offset: int, nbytes: int, epoch: int | None = None,
                    ctx: IOCtx = DEFAULT_CTX) -> int:
        if epoch is None:
            epoch = self.container.auto_epoch()
        lay = self._layout()
        plan = self._planner(lay)
        acc = FlowAccumulator(self.stripe_cell)
        for span in plan.spans(offset, nbytes):
            for eid, nb in plan.sized_write_homes(span):
                self._engine(eid).update_hole(self._key("arr", span.cell_no),
                                              self.stripe_cell, epoch)
                acc.add(eid, nb)
        self._record_flows(acc.flows(), "write", ctx)
        self._grow(offset + nbytes)
        self.container.notify_write(self.name, epoch, origin=ctx.cache,
                                    offset=offset, nbytes=nbytes, ctx=ctx)
        return nbytes

    def read_sized(self, offset: int, nbytes: int,
                   epoch: float | None = None,
                   ctx: IOCtx = DEFAULT_CTX) -> int:
        if epoch is None:
            epoch = float(self.container.committed_epoch)
        lay = self._layout()
        plan = self._planner(lay)
        acc = FlowAccumulator(self.stripe_cell)
        recon = 0
        for span in plan.spans(offset, nbytes):
            recon += self._sized_read_span(plan, span, acc)
        self._record_flows(acc.flows(), "read", ctx)
        self._charge_reconstruct(plan, recon, ctx)
        return nbytes

    def _sized_read_span(self, plan: CellPlanner, span,
                         acc: FlowAccumulator) -> int:
        """Liveness-aware cost of one synthetic read span: the sized twin
        of ``_read_cell``'s degraded charging.  Returns 1 when the span
        needed an EC reconstruction (so the caller can charge the client
        XOR pass), 0 otherwise."""
        primary = plan.primary(span.cell_no)
        if self._engine(primary).alive:
            acc.add(primary, span.take)
            return 0
        if self.oclass.ec_data:
            p = plan.ec_placement(span.cell_no)
            if not self._engine(p.parity_engine).alive:
                raise redundancy.DataLossError(
                    f"object {self.name}: cell {span.cell_no} and its parity "
                    "are both unavailable")
            for ln in range(p.k):
                if ln == p.lane:
                    continue
                eid = plan.primary(p.group * p.k + ln)
                if not self._engine(eid).alive:
                    raise redundancy.DataLossError(
                        f"object {self.name}: cell {span.cell_no} "
                        f"unrecoverable (survivor lane {ln} also down — "
                        f"EC_{p.k}P1 tolerates one failure)")
                acc.add(eid, self.stripe_cell)
            acc.add(p.parity_engine, self.stripe_cell)
            return 1
        for eid in plan.replicas(span.cell_no):
            if self._engine(eid).alive:  # degraded read: next replica
                acc.add(eid, span.take)
                return 0
        raise redundancy.DataLossError(
            f"object {self.name}: cell {span.cell_no} unrecoverable "
            f"({self.oclass.name}, all replicas down)")

    def punch(self, ctx: IOCtx = DEFAULT_CTX) -> None:
        lay = self._layout()
        for eid in set(lay.targets):
            eng = self._engine(eid)
            if not eng.alive:
                continue
            for key in list(eng.keys((self.container.label, self.oid))):
                eng.punch(key)
        self.container.set_object_size(self.oid, 0)
        self.container.notify_punch(self.name, origin=ctx.cache, ctx=ctx)


class KVObject(_ObjectBase):
    """daos_kv_*: dkey/akey records hashed across the object's shards."""

    def _planner(self) -> CellPlanner:
        return CellPlanner(self._layout(), self.oclass, self.stripe_cell)

    def _replicas_for(self, dkey) -> tuple[int, ...]:
        return self._planner().kv_replicas(dkey)

    def _shard_for(self, dkey) -> int:
        return self._planner().kv_shard(dkey)

    def put(self, dkey, akey, value, epoch: int | None = None,
            ctx: IOCtx = DEFAULT_CTX) -> None:
        if epoch is None:
            epoch = self.container.auto_epoch()
        raw = value if isinstance(value, (bytes, bytearray)) else bytes(value)
        acc = FlowAccumulator(len(raw))
        last_err: Exception | None = None
        for eid in self._replicas_for(dkey):
            try:  # degraded write: surviving replicas only
                self._engine(eid).update(self._key(dkey, akey), raw, epoch)
            except EngineFailedError as e:
                last_err = e
                continue
            acc.add(eid, len(raw))
        if not acc:
            raise redundancy.DataLossError(
                f"kv {self.name}: no live replica for dkey {dkey!r}") \
                from last_err
        self._record_flows(acc.flows(batch=False), "write", ctx)

    def get(self, dkey, akey, epoch: float | None = None,
            ctx: IOCtx = DEFAULT_CTX) -> bytes:
        if epoch is None:
            epoch = float(self.container.committed_epoch)
        last_err: Exception | None = None
        not_found = 0
        replicas = self._replicas_for(dkey)  # one layout walk per op
        for eid in replicas:  # degraded read: next replica
            try:
                rec = self._engine(eid).fetch(self._key(dkey, akey), epoch)
            except EngineFailedError as e:
                last_err = e
                continue
            except NotFoundError as e:
                # post-rebuild override may point at a fresh engine before
                # records land there; another replica still has the data
                last_err = e
                not_found += 1
                continue
            data = rec.data if rec.data is not None else b"\0" * rec.length
            acc = FlowAccumulator(rec.length)
            acc.add(eid, rec.length)
            self._record_flows(acc.flows(batch=False), "read", ctx)
            return data
        if not_found == len(replicas):
            raise NotFoundError((self.oid, dkey, akey))
        raise redundancy.DataLossError(
            f"kv {self.name}: all replicas of dkey {dkey!r} down") \
            from last_err

    # ---------------- async batch API ----------------
    def batch(self, ctx: IOCtx = DEFAULT_CTX, tx=None,
              qd: int | None = None) -> "KVBatch":
        """Open a pipelined submission window over this object's records.

        Returned ``KVBatch`` is a context manager; ops submitted through it
        return ``QueuedOp`` events on a ``SubmissionQueue`` whose depth
        follows the caller's mount qd (``auto`` maps to the solver's
        overdrive window) — so manifest/index traffic rides the same
        cost-true in-flight model as extent I/O.
        """
        return KVBatch(self, ctx=ctx, tx=tx, qd=qd)

    def put_async(self, dkey, akey, value, ctx: IOCtx = DEFAULT_CTX,
                  batch: "KVBatch | None" = None):
        """Single-shot async put: queue on ``batch`` if given, else open a
        one-op window (flow-identical to the serial ``put``)."""
        if batch is not None:
            return batch.put(dkey, akey, value, obj=self)
        with self.batch(ctx=ctx) as b:
            return b.put(dkey, akey, value)

    def get_async(self, dkey, akey, ctx: IOCtx = DEFAULT_CTX,
                  batch: "KVBatch | None" = None):
        if batch is not None:
            return batch.get(dkey, akey, obj=self)
        with self.batch(ctx=ctx) as b:
            return b.get(dkey, akey)

    def remove(self, dkey, akey=None) -> None:
        for eid in self._replicas_for(dkey):
            eng = self._engine(eid)
            if not eng.alive:
                continue
            if akey is None:
                for key in list(eng.keys((self.container.label, self.oid,
                                          dkey))):
                    eng.punch(key)
            else:
                eng.punch(self._key(dkey, akey))

    def list_akeys(self, dkey) -> list:
        eid = self._shard_for(dkey)
        return [k[3] for k in
                self._engine(eid).keys((self.container.label, self.oid, dkey))]

    def list_dkeys(self) -> list:
        """Enumerate dkeys across all live shards (daos_kv_list: dkeys are
        hashed over the engines, so every shard must be walked)."""
        lay = self._layout()
        out: set = set()
        for eid in set(lay.targets):
            eng = self._engine(eid)
            if not eng.alive:
                continue
            for key in eng.keys((self.container.label, self.oid)):
                out.add(key[2])
        return sorted(out)


class KVBatch:
    """Pipelined dkey/akey operations over one (or more) ``KVObject``.

    The serial KV path charges every record as its own RPC chain; a batch
    queues ops on a ``SubmissionQueue`` bounded per engine and renders the
    accumulated per-engine flows *once*, with DAOS IOD descriptor batching
    applied — one RPC carries ~``IOD_BATCH`` record descriptors — exactly
    like ``ArrayObject`` extent writes.  With a window of 1 (sync mounts,
    or ``qd=1``) every op executes immediately through the serial
    ``put``/``get``, so the batch is byte- and flow-identical to not using
    it at all.

    Under a transaction the batch registers itself as one of the tx's
    submission queues: ``commit`` drains it (queued records must reach the
    engines before the epoch turns visible) and ``abort`` discards the
    unexecuted tail, the same barriers extent handles get.  Cross-object
    puts (``obj=`` on each op) let one window pipeline manifest + session
    index records together.
    """

    def __init__(self, obj: KVObject, ctx: IOCtx = DEFAULT_CTX,
                 tx=None, qd: int | None = None) -> None:
        self.obj = obj
        self.ctx = ctx
        self.tx = tx
        self.window = self._resolve_window(ctx, qd)
        self._sq = SubmissionQueue(qd=self.window)
        self._accs: dict[str, FlowAccumulator] = {}
        if tx is not None:
            tx.register_subq(self)

    def _resolve_window(self, ctx: IOCtx, qd: int | None) -> int:
        if qd is not None:
            return max(1, int(qd))
        if ctx.sync:
            return 1  # blocking per-op round trips: nothing to pipeline
        hw_qd = self.obj.pool.sim.hw.queue_depth
        if ctx.qd == AUTO_QD:
            # offer the overdrive ceiling; the solver trims each
            # (process, engine) window to its useful share
            return 2 * hw_qd
        return int(ctx.qd) if ctx.qd > 0 else hw_qd

    # -- submission ----------------------------------------------------------
    def _acc(self, direction: str) -> FlowAccumulator:
        acc = self._accs.get(direction)
        if acc is None:
            acc = self._accs[direction] = FlowAccumulator(0)
        return acc

    def put(self, dkey, akey, value, obj: KVObject | None = None):
        o = self.obj if obj is None else obj
        raw = value if isinstance(value, (bytes, bytearray)) else bytes(value)
        engines = o._replicas_for(dkey)
        if self.tx is not None:
            self.tx._check_open()
            for eid in engines:
                self.tx.touch(eid)
        if self.window <= 1:
            if self.tx is not None:
                fn = lambda: self.tx.put_kv(o, dkey, akey, raw, ctx=self.ctx)
            else:
                fn = lambda: o.put(dkey, akey, raw, ctx=self.ctx)
        else:
            fn = lambda: self._exec_put(o, dkey, akey, raw, engines)
        return self._sq.submit(fn, engines)

    def _exec_put(self, o: KVObject, dkey, akey, raw: bytes,
                  engines) -> int:
        epoch = (self.tx.epoch if self.tx is not None
                 else o.container.auto_epoch())
        acc = self._acc("write")
        wrote = 0
        last_err: Exception | None = None
        for eid in engines:
            try:  # degraded write: surviving replicas only
                o._engine(eid).update(o._key(dkey, akey), raw, epoch)
            except EngineFailedError as e:
                last_err = e
                continue
            wrote += 1
            acc.add(eid, len(raw))
        if not wrote:
            raise redundancy.DataLossError(
                f"kv {o.name}: no live replica for dkey {dkey!r}") \
                from last_err
        return len(raw)

    def get(self, dkey, akey, obj: KVObject | None = None):
        o = self.obj if obj is None else obj
        engines = o._replicas_for(dkey)
        if self.window <= 1:
            epoch = float(self.tx.epoch) if self.tx is not None else None
            fn = lambda: o.get(dkey, akey, epoch=epoch, ctx=self.ctx)
        else:
            fn = lambda: self._exec_get(o, dkey, akey, engines)
        return self._sq.submit(fn, engines[:1])

    def _exec_get(self, o: KVObject, dkey, akey, engines) -> bytes:
        epoch = (float(self.tx.epoch) if self.tx is not None
                 else float(o.container.committed_epoch))
        last_err: Exception | None = None
        not_found = 0
        for eid in engines:  # degraded read: next replica
            try:
                rec = o._engine(eid).fetch(o._key(dkey, akey), epoch)
            except EngineFailedError as e:
                last_err = e
                continue
            except NotFoundError as e:
                last_err = e
                not_found += 1
                continue
            self._acc("read").add(eid, rec.length)
            return rec.data if rec.data is not None else b"\0" * rec.length
        if not_found == len(engines):
            raise NotFoundError((o.oid, dkey, akey))
        raise redundancy.DataLossError(
            f"kv {o.name}: all replicas of dkey {dkey!r} down") \
            from last_err

    def remove(self, dkey, akey=None, obj: KVObject | None = None):
        o = self.obj if obj is None else obj
        engines = o._replicas_for(dkey)
        return self._sq.submit(lambda: o.remove(dkey, akey), engines)

    # -- completion (tx barriers call these like any submission queue) -------
    def flush(self) -> None:
        """Retire every queued op, then render the accumulated flows as one
        IOD-batched recording per direction."""
        try:
            self._sq.flush()
        finally:
            self._record()

    def discard(self) -> None:
        """Abort path: drop the unexecuted tail, but ops that already ran
        hit the engines — their RPC flows still happened and stay
        recorded."""
        self._sq.discard()
        self._record()

    def _record(self) -> None:
        accs, self._accs = self._accs, {}
        for direction, acc in accs.items():
            if acc:
                self.obj._record_flows(acc.flows(batch=True), direction,
                                       self.ctx)

    @property
    def inflight(self) -> int:
        return self._sq.inflight

    def __enter__(self) -> "KVBatch":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.flush()
        else:
            self.discard()

"""Unified I/O request pipeline: cell planning + flow accounting.

Every data op in the store reduces to the same three steps:

1. **plan** — split a byte range ``(offset, nbytes)`` into stripe-cell spans
   and resolve which engines serve each span (replicas, or EC data+parity
   lanes) — ``CellPlanner``;
2. **execute** — move (or, on the sized/synthetic path, account) the bytes;
3. **record** — accumulate per-engine ``(nbytes, nops, cell)`` triples,
   apply DAOS IOD descriptor batching, and hand the flows to the pool's
   ``IOSim`` — ``FlowAccumulator``.

Before this module existed, ``ArrayObject.write`` / ``read`` /
``write_sized`` / ``read_sized`` each re-implemented all three steps (and
``KVObject`` a fourth variant), so any layer that wanted to absorb or
coalesce an op — a client cache, readahead, write-back — had nowhere to
stand.  The planner/accumulator pair is that seam: ``cache.ClientCache``
sits between the interface layer and this pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

from . import layout as _layout

#: DAOS IOD semantics: one RPC per engine carries a batch of cell
#: descriptors; we charge ~1 RPC per this many cells touched.
IOD_BATCH = 4


def iod_batch(nops: int) -> int:
    """Collapse per-cell op counts into batched RPC counts (>= 1)."""
    return max(1, nops // IOD_BATCH)


#: container_seq used to salt the dkey hash — distinct from any real
#: container sequence so dkey placement never collides with oid allocation.
_KV_HASH_SEQ = 17


def kv_replica_targets(lay: _layout.StripeLayout,
                       dkey) -> tuple[int, ...]:
    """Engines holding one dkey's record under ``lay``.

    The ONE definition of the dkey→replica hash: the dkey hashes onto a
    stripe chunk and rides its replica set.  Placement
    (``CellPlanner.kv_replicas``) and rebuild (``Pool._copy_kv_records``)
    both resolve through here, so the two can't drift — a record re-homed
    by rebuild lands exactly where a post-rebuild read will look for it.
    """
    h = _layout.oid_for(str(dkey), container_seq=_KV_HASH_SEQ)
    return lay.replicas_for_chunk(h % lay.width)


@dataclasses.dataclass(frozen=True)
class CellSpan:
    """One contiguous piece of a request inside a single stripe cell."""
    cell_no: int      # absolute cell index in the object
    in_cell: int      # byte offset of the span inside the cell
    take: int         # span length in bytes

    @property
    def end(self) -> int:
        return self.in_cell + self.take


@dataclasses.dataclass(frozen=True)
class ECPlacement:
    """Engine roles for one cell of an EC_kP1 object."""
    data_engine: int
    parity_engine: int
    group: int        # parity group index
    lane: int         # data lane inside the group
    k: int            # data width


class CellPlanner:
    """Turns ``(offset, nbytes)`` into cell spans + per-engine placement.

    One planner per (layout, object class, stripe cell) triple — i.e. per
    ``ArrayObject`` data op, since rebuild overrides can change the layout
    between ops.
    """

    def __init__(self, lay: _layout.StripeLayout,
                 oclass: _layout.ObjectClass, stripe_cell: int) -> None:
        self.lay = lay
        self.oclass = oclass
        self.stripe_cell = stripe_cell

    # ---------------- geometry ----------------
    def data_width(self) -> int:
        if self.oclass.ec_data:
            return max(1, self.lay.width - self.oclass.ec_parity)
        return self.lay.width

    def spans(self, offset: int, nbytes: int) -> Iterator[CellSpan]:
        """Walk the stripe cells covering ``[offset, offset + nbytes)``."""
        cell = self.stripe_cell
        pos = 0
        while pos < nbytes:
            cell_no, in_cell = divmod(offset + pos, cell)
            take = min(cell - in_cell, nbytes - pos)
            yield CellSpan(cell_no, in_cell, take)
            pos += take

    # ---------------- placement ----------------
    def ec_placement(self, cell_no: int) -> ECPlacement:
        k = self.data_width()
        group, lane = divmod(cell_no, k)
        width = self.lay.width
        return ECPlacement(
            data_engine=self.lay.targets[(group + lane) % width],
            parity_engine=self.lay.targets[(group + k) % width],
            group=group, lane=lane, k=k)

    def replicas(self, cell_no: int) -> tuple[int, ...]:
        return self.lay.replicas_for_chunk(cell_no)

    def cell_engines(self, cell_no: int):
        """Replica tuple, or ``(data, parity, group, lane, k)`` for EC —
        the legacy shape ``pool.Rebuilder`` still consumes."""
        if self.oclass.ec_data:
            p = self.ec_placement(cell_no)
            return (p.data_engine, p.parity_engine, p.group, p.lane, p.k)
        return self.replicas(cell_no)

    def primary(self, cell_no: int) -> int:
        """The engine a read targets first."""
        if self.oclass.ec_data:
            return self.ec_placement(cell_no).data_engine
        return self.replicas(cell_no)[0]

    def touched_engines(self, offset: int, nbytes: int,
                        write: bool = False) -> set[int]:
        """Engines a request will send IODs to — the keys a submission
        queue bounds its per-engine in-flight window by.  Writes touch
        every replica (or the EC data + parity lanes); reads only the
        primary of each cell."""
        out: set[int] = set()
        for span in self.spans(offset, nbytes):
            if not write:
                out.add(self.primary(span.cell_no))
            elif self.oclass.ec_data:
                p = self.ec_placement(span.cell_no)
                out.add(p.data_engine)
                out.add(p.parity_engine)
            else:
                out.update(self.replicas(span.cell_no))
        return out

    # ---------------- kv placement ----------------
    def kv_replicas(self, dkey) -> tuple[int, ...]:
        """Engines holding one dkey's record (daos_obj_update fan-out):
        the dkey hashes onto a stripe chunk and rides its replica set —
        the KV analogue of :meth:`replicas`, so batched KV submission can
        bound its per-engine windows exactly like extent IODs.  Delegates
        to the shared :func:`kv_replica_targets` — the same helper rebuild
        uses, so record movement and record lookup can't diverge."""
        return kv_replica_targets(self.lay, dkey)

    def kv_shard(self, dkey) -> int:
        """The shard a single-replica KV op (listing, primary read)
        targets first."""
        return self.kv_replicas(dkey)[0]

    def sized_write_homes(self, span: CellSpan) -> tuple[tuple[int, int], ...]:
        """(engine, accounted_bytes) pairs for a synthetic write of ``span``:
        every replica carries the span; EC charges the data lane in full and
        the parity engine its 1/k share."""
        if self.oclass.ec_data:
            p = self.ec_placement(span.cell_no)
            return ((p.data_engine, span.take),
                    (p.parity_engine, span.take // p.k + 1))
        return tuple((e, span.take) for e in self.replicas(span.cell_no))


class FlowAccumulator:
    """Per-engine ``[nbytes, nops, cell]`` accounting for one data op.

    Owns the IOD-batching rule (previously four inline copies of
    ``acc[1] = max(1, acc[1] // 4)`` in ``object.py``) and renders the
    final flow dict that ``_ObjectBase._record_flows`` consumes.
    """

    def __init__(self, default_cell: int) -> None:
        self.default_cell = default_cell
        self._acc: dict[int, list] = {}

    def add(self, engine_id: int, nbytes: int, nops: int = 1,
            cell: int | None = None) -> None:
        acc = self._acc.setdefault(
            engine_id, [0, 0, self.default_cell if cell is None else cell])
        acc[0] += nbytes
        acc[1] += nops

    def __bool__(self) -> bool:
        return bool(self._acc)

    def __len__(self) -> int:
        return len(self._acc)

    def engines(self) -> list[int]:
        return list(self._acc)

    def total_bytes(self) -> int:
        return sum(a[0] for a in self._acc.values())

    def flows(self, batch: bool = True) -> dict[int, tuple[int, int, int]]:
        """Render ``engine -> (nbytes, nops, cell)``, applying IOD batching
        to the op counts unless ``batch=False`` (KV ops are single-record
        RPCs and don't batch)."""
        return {eid: (acc[0], iod_batch(acc[1]) if batch else acc[1], acc[2])
                for eid, acc in self._acc.items()}

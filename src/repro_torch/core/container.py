"""Containers: the transaction/epoch domain inside a pool.

A container owns an object namespace, the committed-epoch watermark that makes
transactions atomic, snapshots, and the per-object metadata (class, size,
rebuild overrides).  Durable metadata mutations (create, snapshot, tx commit,
layout overrides) go through the pool's RAFT group; the epoch allocator and
size cache are client-side state, as in DAOS.
"""
from __future__ import annotations

import itertools

from . import layout as _layout
from .object import ArrayObject, KVObject
from .transactions import Transaction


class Container:
    def __init__(self, pool, label: str, default_oclass: str = "SX",
                 stripe_cell: int = 1 << 20) -> None:
        self.pool = pool
        self.label = label
        self.default_oclass = default_oclass
        self.stripe_cell = stripe_cell
        self._epoch_alloc = itertools.count(1)
        self._committed = 0
        self._sizes: dict[int, int] = {}
        self._oclasses: dict[int, str] = {}
        self._overrides: dict[int, dict[int, int]] = {}  # oid -> {dead: new}
        self.snapshots: list[int] = []
        self._caches: list = []      # attached ClientCaches (coherence fan-out)

    # ------------- epochs / transactions -------------
    @property
    def committed_epoch(self) -> int:
        return self._committed

    def alloc_epoch(self) -> int:
        return next(self._epoch_alloc)

    def auto_epoch(self) -> int:
        """Independent (non-tx) updates are immediately visible."""
        e = self.alloc_epoch()
        self._committed = max(self._committed, e)
        return e

    def tx_begin(self) -> Transaction:
        return Transaction(self)

    def commit_tx(self, tx: Transaction) -> None:
        # commit barrier: write-back data staged under this tx must reach
        # the engines BEFORE the epoch becomes visible.  A client crash
        # before this point leaves the whole epoch invisible (atomic); after
        # it, readers of the committed epoch see every byte.  This is what
        # keeps torn-save protection intact under client-side caching.
        # Queued async IODs drain first — they may themselves stage dirty
        # cache data the flush below must then push out.
        for sq in list(getattr(tx, "subqueues", ())):
            sq.flush()
        for c in list(self._caches):
            flush = getattr(c, "flush_tx", None)
            if flush is not None:
                flush(tx)
        self._committed = max(self._committed, tx.epoch)
        self.pool.raft.set(("cont_epoch", self.label), self._committed)
        # commit is when the staged bytes *change what readers see*: replay
        # the tx's write log as coherence events so foreign caches that
        # refetched pre-commit bytes during staging drop/destale them now
        # (sibling caches of this very tx hold the fresh bytes and are
        # exempted by the policies' _tx_sibling rule as usual)
        for name, offset, nbytes, ctx in getattr(tx, "write_log", ()):
            self.notify_write(name, tx.epoch,
                              origin=getattr(ctx, "cache", None),
                              offset=offset, nbytes=nbytes, ctx=ctx)

    def abort_tx(self, tx: Transaction) -> int:
        # queued-but-unexecuted IODs never reach the engines: their bytes
        # belong to the epoch being punched (each completes with a
        # TxStateError so waiting callers learn the write was torn away)
        for sq in list(getattr(tx, "subqueues", ())):
            sq.discard()
        # staged cache state for a punched epoch is garbage everywhere
        for c in list(self._caches):
            drop = getattr(c, "drop_tx", None)
            if drop is not None:
                drop(tx)
        # punch the epoch on EVERY live engine, not just the ones the tx
        # touched at staging time: a rebuild that ran while the tx was open
        # replays record history — staged records included — onto a
        # replacement engine the tx never saw, and an abort must reach
        # those copies too (epochs are tx-unique, so the wider punch drops
        # exactly this tx's records)
        punch_on = set(tx.touched_engines) | (
            set(self.pool.live_engine_ids()) if tx.touched_engines else set())
        dropped = 0
        for eid in punch_on:
            eng = self.pool.engines[eid]
            if eng.alive:
                dropped += eng.punch_epoch(tx.epoch)
        return dropped

    def snapshot(self) -> int:
        """Persist the current committed epoch as a named snapshot."""
        snap = self._committed
        self.snapshots.append(snap)
        self.pool.raft.set(("cont_snap", self.label, len(self.snapshots)), snap)
        return snap

    # ------------- client-cache coherence -------------
    # dfuse-style caches register here; writes/punches that reach the
    # object layer are routed through each attached cache's coherence
    # policy (core/coherence.py) — the container fans events out but makes
    # no invalidation decision itself.
    def attach_cache(self, cache) -> None:
        if cache not in self._caches:
            cache.sim = self.pool.sim   # delivery cost accounting
            self._caches.append(cache)

    def detach_cache(self, cache) -> None:
        if cache in self._caches:
            self._caches.remove(cache)

    def notify_write(self, name: str, epoch: int, origin=None,
                     offset: int = 0, nbytes: int | None = None,
                     ctx=None) -> None:
        """Fan a write event out to every attached cache's policy.  The
        event carries the touched extent ``(offset, nbytes)`` (``nbytes``
        None = unknown: treat as the whole object) and the writer's
        ``ctx`` so costed delivery can charge the origin process.  Fires
        for *every* object-layer write — including ones from uncached
        (coherence=off) mounts, whose ``origin`` is None: off-writers
        still bump engine tokens and cached mounts still hear about
        them.  Tx-staged writes notify here too, even though their bytes
        are not committed-visible yet: the committed watermark is a max,
        so staged records *leak* into the committed view the moment any
        later auto-epoch write lands — revoking at staging conservatively
        covers that window (the conformance harness catches real stale
        serves if this is skipped), and the commit-time write-log replay
        covers caches that refetched pre-commit bytes in between."""
        if not self._caches:
            return
        now = self.pool.sim.clock.now
        for c in list(self._caches):
            c.policy.remote_write(c, name, epoch, origin, now,
                                  offset=offset, nbytes=nbytes, ctx=ctx)

    def notify_punch(self, name: str, origin=None, ctx=None) -> None:
        if not self._caches:
            return
        now = self.pool.sim.clock.now
        for c in list(self._caches):
            c.policy.punch(c, name, origin, now, ctx=ctx)

    # ------------- objects -------------
    def _resolve_class(self, oclass: str | _layout.ObjectClass | None
                       ) -> _layout.ObjectClass:
        if oclass is None:
            oclass = self.default_oclass
        if isinstance(oclass, str):
            oclass = _layout.get_class(oclass)
        return oclass

    def open_array(self, name: str, oclass=None,
                   stripe_cell: int | None = None) -> ArrayObject:
        oc = self._resolve_class(oclass)
        oid = _layout.oid_for(name)
        self._oclasses.setdefault(oid, oc.name)
        return ArrayObject(self, name, oid, oc,
                           stripe_cell or self.stripe_cell)

    def open_kv(self, name: str, oclass=None) -> KVObject:
        oc = self._resolve_class(oclass)
        oid = _layout.oid_for(name)
        self._oclasses.setdefault(oid, oc.name)
        return KVObject(self, name, oid, oc, self.stripe_cell)

    # ------------- placement (incl. rebuild overrides) -------------
    def layout_for(self, oid: int, oclass: _layout.ObjectClass,
                   stripe_cell: int) -> _layout.StripeLayout:
        base = _layout.place_object(
            oid, oclass, self.pool.all_engine_ids(),
            map_version=self.pool.base_map_version,
            stripe_cell=stripe_cell,
            node_of={e: self.pool.engines[e].node_id
                     for e in self.pool.all_engine_ids()})
        over = self._overrides.get(oid)
        if not over:
            return base
        targets = tuple(over.get(t, t) for t in base.targets)
        return _layout.StripeLayout(oid=base.oid, oclass=base.oclass,
                                    targets=targets,
                                    stripe_cell=base.stripe_cell)

    def set_override(self, oid: int, dead: int, replacement: int) -> None:
        over = self._overrides.setdefault(oid, {})
        # transitive chase: an earlier dead->X override whose X itself just
        # died must follow the new replacement, or ``layout_for`` (which
        # maps BASE targets through the table exactly once) would keep
        # resolving to the dead X after a second failure+rebuild cycle
        for d, r in list(over.items()):
            if r == dead:
                over[d] = replacement
                self.pool.raft.set(("cont_override", self.label, oid, d),
                                   replacement)
        over[dead] = replacement
        self.pool.raft.set(("cont_override", self.label, oid, dead),
                           replacement)

    # ------------- object metadata -------------
    def object_size(self, oid: int) -> int:
        return self._sizes.get(oid, 0)

    def set_object_size(self, oid: int, size: int) -> None:
        self._sizes[oid] = size

    def object_class_of(self, oid: int) -> str | None:
        return self._oclasses.get(oid)

    def known_oids(self) -> list[int]:
        return list(self._oclasses)

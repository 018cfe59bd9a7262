"""Pools: a set of DAOS engines + the replicated control plane.

The pool owns the engines (real byte stores), the IOSim timing model, and the
RAFT metadata group.  Failure handling follows DAOS semantics:

* ``fail_engine`` / ``fail_node`` bump the pool-map version through RAFT;
  ``fail_node`` additionally fences the co-resident client (converged
  deployment): leases drop, dirty write-back is lost, open transactions
  abort so their half-staged epochs are punched server-side;
* ``rebuild()`` restores redundancy for RP_*/EC_* objects by reconstructing
  the shards that lived on dead engines onto live replacements (recorded as
  per-object layout overrides so placement of surviving shards never moves).
  Rebuild traffic is *costed*: every byte it moves flows through the IOSim —
  as background debt when a foreground phase is active (so rebuild genuinely
  competes with foreground I/O for media and NIC time), as its own foreground
  phase otherwise;
* unprotected (S*) data on a dead engine raises ``DataLossError`` on access —
  the honest failure mode the paper's object classes trade against.

Rebuild replays each record's FULL epoch history onto the replacement, not
just the committed image: a transaction still open when rebuild runs has
staged (invisible) records that must exist on the replacement for its later
commit to be readable there — and ``Container.abort_tx`` punches every live
engine for the same reason.
"""
from __future__ import annotations

from . import layout as _layout
from . import redundancy as _redundancy
from .container import Container
from .engine import Engine, EngineFailedError, NotFoundError
from .iopath import kv_replica_targets
from .multipart import MP_PART_BYTES, plan_parts, should_multipart
from .raft import RaftGroup
from .redundancy import DataLossError
from .simnet import IOSim, Topology, HWProfile

#: rebuild streams are pseudo-processes well below any real process id so
#: their serial chains never alias a benchmark worker's
_REBUILD_PROC = -(1 << 16)


class Rebuilder:
    """Incremental, costed rebuild of everything the dead engines held.

    The plan is fixed at construction: one *group* per (object, dead
    target) pair, each a list of copy units (replica cells, EC data cells,
    EC parity groups, KV records).  ``step(max_bytes)`` applies units until
    the byte budget is spent, recording the reads from survivors and the
    write to the replacement as simulator flows; a group's layout override
    is published only when its last unit lands, so reads never resolve to a
    half-filled replacement.  ``pool.rebuild()`` drives a Rebuilder to
    completion; benchmarks interleave ``step()`` with foreground phases to
    measure the rebuild-vs-foreground contention frontier (claim F2).

    Flow attribution: rebuild I/O is issued by per-client-node streams
    (pseudo-processes), ``sync=False`` — the DAOS rebuild engine is a
    server-side bulk mover, approximated here by the same flow solver the
    data path uses.  ``bw_cap`` (bytes/s, 0 = unthrottled) is split evenly
    across streams; units at or above the multipart threshold fan out in
    ``part_bytes`` parts across all streams like a large PUT would.
    """

    def __init__(self, pool: "Pool", bw_cap: float = 0.0,
                 part_bytes: int = MP_PART_BYTES) -> None:
        self.pool = pool
        self.bw_cap = float(bw_cap)
        self.part_bytes = max(1, int(part_bytes))
        self.n_streams = max(1, pool.topo.n_client_nodes)
        self.dead = [i for i, e in pool.engines.items() if not e.alive]
        self.moved_cells = 0
        self.moved_bytes = 0
        self.lost_objects = 0
        self._stream = 0
        self._groups = self._plan()
        self._gi = 0

    # ---------------- planning ----------------
    def _plan(self) -> list[dict]:
        from .object import ArrayObject
        dead = set(self.dead)
        groups: list[dict] = []
        for cont in self.pool.containers.values():
            for oid in cont.known_oids():
                oc = _layout.get_class(cont.object_class_of(oid))
                lay = cont.layout_for(oid, oc, cont.stripe_cell)
                dead_targets = [t for t in lay.targets if t in dead]
                if not dead_targets:
                    continue
                if oc.replicas == 1 and not oc.ec_data:
                    self.lost_objects += 1
                    continue
                obj = ArrayObject(cont, f"oid:{oid:x}", oid, oc,
                                  cont.stripe_cell)
                taken = set(lay.targets)
                # replica columns: position i of the target list serves
                # chunk column i % width, so the engines co-holding the
                # dead target's cells are exactly its columns' members —
                # the set a replacement must avoid on wide layouts
                w = max(1, lay.width)
                cols: dict[int, set[int]] = {}
                for i, t in enumerate(lay.targets):
                    cols.setdefault(i % w, set()).add(t)
                for dt in sorted(set(dead_targets)):
                    dcols = [i % w for i, t in enumerate(lay.targets)
                             if t == dt]
                    co = set()
                    for c in dcols:
                        co |= cols[c]
                    co.discard(dt)
                    repl = self.pool._replacement_for(oid, dt, taken,
                                                      co_holders=co)
                    taken.add(repl)
                    for c in dcols:     # later same-column picks see it
                        cols[c].add(repl)
                    groups.append({
                        "cont": cont, "oid": oid, "obj": obj, "lay": lay,
                        "dead": dt, "repl": repl, "next": 0,
                        "units": self._plan_units(cont, obj, lay, dt)})
        return groups

    def _plan_units(self, cont, obj, lay, dead: int) -> list[tuple]:
        units: list[tuple] = []
        size = cont.object_size(obj.oid)
        if size > 0:
            n_cells = -(-size // obj.stripe_cell)
            if obj.oclass.ec_data:
                pgroups: set[int] = set()
                for cn in range(n_cells):
                    d_eng, p_eng, group, _lane, _k = obj._cell_engines(
                        lay, cn)
                    if d_eng == dead:
                        units.append(("ec_cell", cn))
                    if p_eng == dead:
                        pgroups.add(group)
                units.extend(("ec_parity", g) for g in sorted(pgroups))
            else:
                units.extend(("cell", cn) for cn in range(n_cells)
                             if dead in lay.replicas_for_chunk(cn))
        units.extend(("kv", key)
                     for key in self._kv_keys(cont, obj, lay, dead))
        return units

    def _kv_keys(self, cont, obj, lay, dead: int) -> list[tuple]:
        """KV records (dir entries, manifests) whose replica set included
        the dead engine — resolved through the same shared hash the data
        path uses, so movement and lookup can't drift."""
        seen: set = set()
        out: list[tuple] = []
        for eid in sorted(set(lay.targets)):
            eng = self.pool.engines.get(eid)
            if eng is None or not eng.alive:
                continue
            for key in list(eng.keys((cont.label, obj.oid))):
                dkey = key[2]
                if dkey in ("arr", "par") or key in seen:
                    continue
                if dead not in kv_replica_targets(lay, dkey):
                    continue
                seen.add(key)
                out.append(key)
        return out

    # ---------------- progress ----------------
    @property
    def done(self) -> bool:
        return self._gi >= len(self._groups)

    def step(self, max_bytes: int | None = None) -> int:
        """Move up to ``max_bytes`` of rebuild traffic (write-side bytes;
        None = everything).  Always makes progress: at least one unit is
        applied per call while work remains.  Returns bytes moved."""
        if self.done:
            return 0
        sim = self.pool.sim
        ctx = (sim.background_phase() if sim.active_phase is not None
               else sim.phase())
        moved = 0
        with ctx:
            while not self.done and (max_bytes is None or moved < max_bytes):
                g = self._groups[self._gi]
                if g["next"] >= len(g["units"]):
                    g["cont"].set_override(g["oid"], g["dead"], g["repl"])
                    self._gi += 1
                    continue
                unit = g["units"][g["next"]]
                g["next"] += 1
                moved += self._apply(g, unit)
                if g["next"] >= len(g["units"]):
                    g["cont"].set_override(g["oid"], g["dead"], g["repl"])
                    self._gi += 1
        self.moved_bytes += moved
        return moved

    def run(self) -> dict:
        while not self.done:
            self.step()
        return self.summary()

    def summary(self) -> dict:
        return {"dead_engines": self.dead, "moved_cells": self.moved_cells,
                "lost_objects": self.lost_objects,
                "moved_bytes": self.moved_bytes}

    # ---------------- unit application ----------------
    def _apply(self, g: dict, unit: tuple) -> int:
        kind, arg = unit
        if kind == "cell":
            return self._apply_cell(g, arg)
        if kind == "ec_cell":
            return self._apply_ec_cell(g, arg)
        if kind == "ec_parity":
            return self._apply_ec_parity(g, arg)
        return self._apply_kv(g, arg)

    def _replay(self, reng: Engine, key: tuple, recs: dict) -> int:
        """Replay a record's full epoch history onto the replacement."""
        n = 0
        for epoch in sorted(recs):
            rec = recs[epoch]
            if rec.data is None:
                reng.update_hole(key, rec.length, epoch)
            else:
                reng.update(key, rec.data, epoch, csum=rec.csum)
            n += rec.length
        return n

    def _apply_cell(self, g: dict, cn: int) -> int:
        cont, obj, lay = g["cont"], g["obj"], g["lay"]
        key = (cont.label, obj.oid, "arr", cn)
        src_id, src = self._find_src(g, lay.replicas_for_chunk(cn), key)
        if src is None:
            return 0
        recs = src.records(key)
        nbytes = self._replay(self.pool.engines[g["repl"]], key, recs)
        self.moved_cells += 1
        self._charge([(src_id, "read", nbytes, len(recs)),
                      (g["repl"], "write", nbytes, len(recs))])
        return nbytes

    def _apply_kv(self, g: dict, key: tuple) -> int:
        src_id, src = self._find_src(g, sorted(set(g["lay"].targets)), key)
        if src is None:
            return 0
        recs = src.records(key)
        nbytes = self._replay(self.pool.engines[g["repl"]], key, recs)
        self.moved_cells += 1
        self._charge([(src_id, "read", nbytes, len(recs)),
                      (g["repl"], "write", nbytes, len(recs))])
        return nbytes

    def _find_src(self, g: dict, candidates, key: tuple):
        for eid in candidates:
            eng = self.pool.engines.get(eid)
            if (eid != g["dead"] and eng is not None and eng.alive
                    and eng.exists(key)):
                return eid, eng
        return None, None

    def _apply_ec_cell(self, g: dict, cn: int) -> int:
        """Reconstruct a lost EC data cell at every epoch the parity group
        changed (a superset of the lost lane's own history — redundant
        epochs reconstruct to the then-current value, which is harmless
        for newest-at-or-below-epoch resolution and still punched
        correctly on abort since epochs are tx-unique)."""
        cont, obj, lay = g["cont"], g["obj"], g["lay"]
        sc = obj.stripe_cell
        _d_eng, p_eng, group, lane, k = obj._cell_engines(lay, cn)
        peng = self.pool.engines.get(p_eng)
        if peng is None or not peng.alive:
            raise DataLossError(
                f"cell {cn}: data and parity engines both down — "
                f"EC_{k}P1 tolerates one failure")
        par_key = (cont.label, obj.oid, "par", group)
        precs = peng.records(par_key)
        if not precs:
            return 0
        key = (cont.label, obj.oid, "arr", cn)
        reng = self.pool.engines[g["repl"]]
        reads: dict[int, int] = {}
        nbytes = 0
        for epoch in sorted(precs):
            prec = precs[epoch]
            survivors: list[bytes] = []
            for ln in range(k):
                if ln == lane:
                    continue
                scn = group * k + ln
                s_eid = obj._cell_engines(lay, scn)[0]
                s_eng = self.pool.engines[s_eid]
                if not s_eng.alive:
                    raise DataLossError(
                        f"EC survivor lane {ln} (engine {s_eid}) also "
                        f"down during rebuild — EC_{k}P1 tolerates one "
                        "failure")
                try:
                    srec = s_eng.fetch((cont.label, obj.oid, "arr", scn),
                                       epoch)
                except NotFoundError:
                    continue
                reads[s_eid] = reads.get(s_eid, 0) + srec.length
                survivors.append(srec.data if srec.data is not None
                                 else b"\0" * srec.length)
            reads[p_eng] = reads.get(p_eng, 0) + prec.length
            if prec.data is None:
                # sized (non-materialised) run: same traffic, hole record
                reng.update_hole(key, sc, epoch)
                nbytes += sc
            else:
                lost = _redundancy.reconstruct(survivors, prec.data, sc, sc)
                reng.update(key, lost, epoch)
                nbytes += len(lost)
        self.moved_cells += 1
        flows = [(eid, "read", b, 1) for eid, b in reads.items() if b > 0]
        flows.append((g["repl"], "write", nbytes, max(1, len(precs))))
        self._charge(flows)
        return nbytes

    def _apply_ec_parity(self, g: dict, group: int) -> int:
        """Recompute a lost parity cell at every epoch any lane changed.
        A lane whose engine is also dead is skipped (its data loss
        surfaces loudly on its own ec_cell unit / read path; the parity
        of the remaining lanes is the best restorable state)."""
        cont, obj, lay = g["cont"], g["obj"], g["lay"]
        sc = obj.stripe_cell
        k = obj._data_width(lay)
        lanes = []
        epochs: set[int] = set()
        for ln in range(k):
            cn = group * k + ln
            eid = obj._cell_engines(lay, cn)[0]
            eng = self.pool.engines.get(eid)
            lanes.append((cn, eid, eng))
            if eng is not None and eng.alive:
                epochs.update(eng.records((cont.label, obj.oid, "arr", cn)))
        if not epochs:
            return 0
        par_key = (cont.label, obj.oid, "par", group)
        reng = self.pool.engines[g["repl"]]
        reads: dict[int, int] = {}
        nbytes = 0
        for epoch in sorted(epochs):
            cells: list[bytes] = []
            hole = False
            for cn, eid, eng in lanes:
                if eng is None or not eng.alive:
                    continue
                try:
                    rec = eng.fetch((cont.label, obj.oid, "arr", cn), epoch)
                except NotFoundError:
                    continue
                reads[eid] = reads.get(eid, 0) + rec.length
                if rec.data is None:
                    hole = True
                else:
                    cells.append(rec.data)
            if hole:
                reng.update_hole(par_key, sc, epoch)
                nbytes += sc
            else:
                parity = _redundancy.xor_parity(cells, sc)
                reng.update(par_key, parity, epoch)
                nbytes += len(parity)
        self.moved_cells += 1
        flows = [(eid, "read", b, 1) for eid, b in reads.items() if b > 0]
        flows.append((g["repl"], "write", nbytes, max(1, len(epochs))))
        self._charge(flows)
        return nbytes

    # ---------------- flow accounting ----------------
    def _charge(self, flows: list[tuple]) -> None:
        per_cap = self.bw_cap / self.n_streams if self.bw_cap else 0.0
        for eid, direction, nbytes, nops in flows:
            if nbytes <= 0:
                continue
            if should_multipart(nbytes) and self.part_bytes < nbytes:
                for pi, (lo, hi) in enumerate(
                        plan_parts(nbytes, self.part_bytes)):
                    self._rec(eid, direction, hi - lo, 1,
                              (self._stream + pi) % self.n_streams, per_cap)
            else:
                self._rec(eid, direction, nbytes, nops, self._stream,
                          per_cap)
        self._stream = (self._stream + 1) % self.n_streams

    def _rec(self, eid: int, direction: str, nbytes: int, nops: int,
             stream: int, cap: float) -> None:
        self.pool.sim.record(
            client_node=stream % self.pool.topo.n_client_nodes,
            process=_REBUILD_PROC - stream, engine=eid,
            direction=direction, nbytes=nbytes, nops=max(1, nops),
            proc_bw_cap=cap, sync=False, qd=0)


class Pool:
    def __init__(self, topo: Topology | None = None,
                 hw: HWProfile | str | None = None,
                 svc_replicas: int = 3, materialize: bool = True,
                 stripe_cell: int = 1 << 20, label: str = "pool0") -> None:
        self.label = label
        self.topo = topo or Topology()
        self.sim = IOSim(self.topo, hw)
        self.stripe_cell = stripe_cell
        self.engines: dict[int, Engine] = {
            i: Engine(i, self.topo.node_of_engine(i), materialize=materialize)
            for i in self.topo.engine_ids()}
        self.raft = RaftGroup(svc_replicas)
        self.raft.set(("pool", "map_version"), 1)
        self.base_map_version = 1   # object placement seed (stable across fail)
        self.containers: dict[str, Container] = {}

    # ------------- control plane -------------
    @property
    def map_version(self) -> int:
        return self.raft.get(("pool", "map_version"), 1)

    def _bump_map(self) -> None:
        self.raft.set(("pool", "map_version"), self.map_version + 1)

    def create_container(self, label: str, oclass: str = "SX",
                         stripe_cell: int | None = None) -> Container:
        if label in self.containers:
            raise ValueError(f"container {label!r} exists")
        cont = Container(self, label, default_oclass=oclass,
                         stripe_cell=stripe_cell or self.stripe_cell)
        self.containers[label] = cont
        self.raft.set(("cont", label), {"oclass": oclass})
        return cont

    def open_container(self, label: str) -> Container:
        return self.containers[label]

    # ------------- engines / failures -------------
    def all_engine_ids(self) -> list[int]:
        return sorted(self.engines)

    def live_engine_ids(self) -> list[int]:
        return [i for i, e in sorted(self.engines.items()) if e.alive]

    def fail_engine(self, engine_id: int) -> None:
        self.engines[engine_id].fail()
        self._bump_map()

    def fail_node(self, node_id: int) -> list[int]:
        """Kill every engine on a server node — and, in the converged
        deployment the simulator models (client node i runs on server
        node i when both exist), fence the co-resident client: its
        leases and cached pages drop WITHOUT flushing (a crashed client
        never writes back), and its open transactions abort so their
        half-staged epochs are punched server-side."""
        failed = [i for i, e in self.engines.items() if e.node_id == node_id]
        for i in failed:
            self.engines[i].fail()
        if node_id < self.topo.n_client_nodes:
            self._fence_client_caches({int(node_id)})
        self._bump_map()
        return failed

    def fail_client(self, client_node: int) -> list:
        """A client node crashes (engines unaffected): fence its caches —
        dirty write-back is lost, leases die with it — and abort its open
        transactions (epoch punch makes any torn, half-flushed save
        invisible, the guarantee the checkpoint layer builds on).
        Returns the aborted transactions."""
        return self._fence_client_caches({int(client_node)})

    def _fence_client_caches(self, nodes: set[int]) -> list:
        aborted = []
        for cont in list(self.containers.values()):
            for c in list(cont._caches):
                if getattr(c, "client_node", None) not in nodes:
                    continue
                fence = getattr(c, "fence", None)
                open_txs = fence(keep_dirty=False) if fence else set()
                cont.detach_cache(c)
                for tx in open_txs:
                    if getattr(tx, "state", None) == "open":
                        tx.abort()
                        aborted.append(tx)
        return aborted

    def restore_engine(self, engine_id: int) -> None:
        """Bring an engine back *empty* (fresh hardware); rebuild must have
        moved its data already.  The engine's version counters reset with
        its contents: a restored engine that kept its old counters could
        re-create a token sum a client remembered from before the failure
        window, letting that client serve stale pages without ever
        revalidating.  Every attached cache is additionally fenced
        (leases and clean pages drop; pending dirty write-back survives
        — those clients are alive and will flush)."""
        eng = self.engines[engine_id]
        eng.restore()
        eng._store.clear()
        eng.used = 0
        eng._obj_tokens.clear()
        eng._sub_tokens.clear()
        for cont in self.containers.values():
            for c in list(cont._caches):
                fence = getattr(c, "fence", None)
                if fence is not None:
                    fence(keep_dirty=True)
        self._bump_map()

    # ------------- rebuild -------------
    def _replacement_for(self, oid: int, dead: int, taken: set[int],
                         co_holders=frozenset()) -> int:
        live_all = self.live_engine_ids()
        if not live_all:
            raise EngineFailedError("no live engine available for rebuild")
        # candidate tiers, strictest first: (1) engines the layout doesn't
        # touch at all; (2) for wide layouts (e.g. RP_2GX, which already
        # span every engine) reuse a live one — but NEVER one holding a
        # surviving replica of the dead target's cells (``co_holders``):
        # co-locating both copies of a cell would turn the next single
        # failure into data loss; (3) any live engine, the last resort
        # when survivors alone can't avoid overlap.
        forbidden = set(co_holders) | {dead}
        for cand in ([e for e in live_all if e not in taken],
                     [e for e in live_all if e not in forbidden],
                     live_all):
            if cand:
                idx = _layout.jump_hash(_layout.oid_for(oid ^ dead),
                                        len(cand))
                return cand[idx]
        raise EngineFailedError("no live engine available for rebuild")

    def rebuilder(self, bw_cap: float = 0.0,
                  part_bytes: int = MP_PART_BYTES) -> Rebuilder:
        """An incremental rebuild handle — benchmarks ``step()`` it between
        foreground phases to study contention; see :class:`Rebuilder`."""
        return Rebuilder(self, bw_cap=bw_cap, part_bytes=part_bytes)

    def rebuild(self, bw_cap: float = 0.0,
                step_bytes: int | None = None) -> dict:
        """Restore redundancy after failures, driving a :class:`Rebuilder`
        to completion. Returns a summary dict."""
        rb = self.rebuilder(bw_cap=bw_cap)
        while not rb.done:
            rb.step(step_bytes)
        return rb.summary()

    # ------------- stats -------------
    def stats(self) -> dict:
        return {
            "map_version": self.map_version,
            "engines": [e.stats() for e in self.engines.values()],
            "containers": sorted(self.containers),
            "sim_time": self.sim.clock.now,
        }

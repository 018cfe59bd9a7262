"""Fleet serving control plane: session-affinity routing over the store.

The serving tier's data path (``KVCacheStore`` on the cached interface
matrix) makes a restore cheap exactly when the session's bytes already sit
in the target node's ``ClientCache``.  At fleet scale that is a *placement*
problem, not an interface problem (the ECMWF follow-on papers' system-level
point): a returning request must land on the node that still holds its
session, spill to the next-best node when that one is saturated, and the
store underneath must stay bounded — evicting cold sessions through the
real pipeline so the cost of staying bounded is measured, not assumed.

``ServeScheduler`` is that control plane, and it is deliberately thin:

* **routing state** — per-node residency books (an LRU mirror of what each
  node's cache plausibly still holds, trimmed to the node's cache budget)
  plus live/saturation flags.  Affinity of a session to a node is the
  resident fraction of the session's bytes; the winner is the warmest
  non-saturated live node, with failover to the least-loaded node when
  the whole fleet is busy.
* **one KV per decision** — a routing decision reads the session's
  ``{step, nbytes, n_leaves}`` record from the store's session index
  (written transactionally at offload) instead of its manifest: O(1)
  small-KV traffic per request where a manifest walk would be
  O(sessions x leaves).
* **bounded store** — ``quota_bytes`` caps the sum of published session
  payloads.  Admission (``reserve``) evicts store-LRU victims through
  ``KVCacheStore.evict`` — real unlink + KV traffic on the pipeline —
  until the incoming session fits; a session larger than the quota is
  refused rather than thrashing the whole store out.

The scheduler holds no raw per-call I/O context and never touches engines
directly: every byte it causes to move goes through the store's
``AccessInterface`` pipeline, so its decisions are costed by the same
solver as the traffic they steer.

The port's copy of the JAX package's scheduler (serve/scheduler.py).  One
thing differs: a cache's size is read from its leaves' shapes, never from
a copy of their bytes, so sizing a session on the card moves nothing.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from ..ckpt import serializer as S
from .kvstore import KVCacheStore, KVStoreError


class SchedulerError(RuntimeError):
    pass


@dataclasses.dataclass
class NodeState:
    """One decode node's routing book."""
    node: int
    alive: bool = True
    active: int = 0                 # in-flight restores routed here
    served: int = 0
    resident_bytes: int = 0
    # session -> resident payload bytes, LRU order (oldest first): a
    # mirror of what the node's ClientCache plausibly still holds
    resident: OrderedDict = dataclasses.field(default_factory=OrderedDict)


def _tree_nbytes(cache) -> int:
    """Payload bytes of a cache tree without touching its data: a tensor's
    ``numel() * element_size()`` (on any device), a host snapshot's bytes;
    any other leaf is refused, as ``leaf_to_bytes`` refuses it."""
    total = 0
    for _path, leaf in S.flatten_tree(cache):
        if isinstance(leaf, S.HostLeaf):
            total += int(leaf.raw.nbytes)
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            raise TypeError(f"a cache leaf is a tensor, not {type(leaf)}")
    return total


class ServeScheduler:
    def __init__(self, store: KVCacheStore, nodes,
                 max_active: int = 8,
                 node_cache_bytes: int = 1 << 30,
                 quota_bytes: int | None = None,
                 speculate_window: int = 0,
                 demote_on_evict: bool | None = None) -> None:
        if not nodes:
            raise SchedulerError("a fleet needs at least one decode node")
        self.store = store
        # demote-instead-of-delete eviction: on a tiered mount, quota
        # pressure spills LRU victims to the cold tier (restorable, off
        # the hot budget) instead of destroying them.  None = autodetect
        # from the mount; asking for it without a cold tier is an error,
        # not a silent fallback to delete.
        tiered = getattr(store.iface, "tier_aware", False)
        if demote_on_evict and not tiered:
            raise SchedulerError(
                "demote_on_evict requires a tiered:// store mount: "
                f"{type(store.iface).__name__} has no cold tier")
        self.demote_on_evict = tiered if demote_on_evict is None \
            else bool(demote_on_evict)
        self.max_active = max(1, int(max_active))
        self.node_cache_bytes = int(node_cache_bytes)
        self.quota_bytes = None if quota_bytes is None else int(quota_bytes)
        # speculative restore prefetch: when > 0, every routing decision
        # issues a readahead of the session's hot window (the last
        # ``speculate_window`` bytes of each leaf) to the routed node as
        # *background* flows (the ra_async machinery) — the prefetch cost
        # becomes debt that drains behind the fleet's decode cadence, so
        # the bytes sit in the node's ClientCache before the request lands
        self.speculate_window = max(0, int(speculate_window))
        self._speculations = 0
        self._spec_bytes = 0
        # manifests read by the speculative prefetch, held for the routed
        # node: the foreground restore collects one instead of re-paying
        # the manifest KV read the speculation already made
        self._spec_manifests: dict[tuple[str, int], dict] = {}
        self._nodes: dict[int, NodeState] = {
            int(n): NodeState(int(n)) for n in nodes}
        # store-level LRU over published sessions (oldest first) + size
        # book, seeded from the session index so a scheduler attached to a
        # live store adopts its population
        self._lru: OrderedDict = OrderedDict()
        self._size: dict[str, int] = {}
        # sessions demoted to the cold tier: off the hot quota, out of the
        # LRU, promoted back through ``ensure_hot`` when a request returns
        self._cold_size: dict[str, int] = {}
        self._decisions = 0
        self._failovers = 0
        self._evictions = 0
        self._evicted_bytes = 0
        self._demotions = 0
        self._demoted_bytes = 0
        self._promotions = 0
        self._index_reads = 0
        for s in store.sessions():
            try:
                meta = store.session_meta(s)
                self._index_reads += 1
            except KVStoreError:
                continue            # torn record with no manifest: skip
            if meta.get("tier", "hot") == "cold":
                self._cold_size[s] = int(meta["nbytes"])
                continue
            self._size[s] = int(meta["nbytes"])
            self._lru[s] = True

    # ------------- routing -------------
    def affinity(self, session: str, node: int) -> float:
        """Resident fraction of the session's payload on one node."""
        ns = self._nodes[int(node)]
        size = max(1, self._size.get(session, 0)
                   or ns.resident.get(session, 0))
        return ns.resident.get(session, 0) / size

    def route(self, session: str) -> int:
        """Pick the decode node for a returning session: the warmest live
        non-saturated node by resident fraction (ties: least loaded, then
        lowest id).  One session-index KV read per decision — the O(1)
        path the index schema exists for.  When every live node is at
        ``max_active`` the request sheds to the least-loaded one (counted
        as a failover, like a pick that loses its warmest node to
        saturation)."""
        meta = self.store.session_meta(session)     # one small KV read
        self._index_reads += 1
        self._decisions += 1
        size = max(1, int(meta["nbytes"]))
        alive = [ns for ns in self._nodes.values() if ns.alive]
        if not alive:
            raise SchedulerError("no live decode nodes")

        def warmth(ns: NodeState):
            return (ns.resident.get(session, 0) / size, -ns.active, -ns.node)

        best = max(alive, key=warmth)
        avail = [ns for ns in alive if ns.active < self.max_active]
        if not avail:
            self._failovers += 1
            shed = min(alive, key=lambda ns: (ns.active, ns.node)).node
            self._maybe_speculate(session, shed, meta)
            return shed
        pick = max(avail, key=warmth)
        if pick is not best:
            self._failovers += 1
        self._maybe_speculate(session, pick.node, meta)
        return pick.node

    def _maybe_speculate(self, session: str, node: int, meta: dict) -> None:
        """Prefetch the session's hot window to the routed node as
        background debt, so the bytes are (ideally) cache-resident before
        the request's foreground restore issues.  A fully-warm target is
        skipped — there is nothing to hide.  Prefetch is best-effort:
        failures never fail the routing decision."""
        if self.speculate_window <= 0:
            return
        if meta.get("tier", "hot") == "cold":
            # a background prefetch would trigger the transparent
            # promotion inside a background phase — tier movement is
            # foreground work, admitted through ensure_hot
            return
        ns = self._nodes.get(int(node))
        if ns is None or not ns.alive:
            return          # never warm a node marked down mid-route
        if self.affinity(session, node) >= 1.0:
            return
        leaf_bytes = int(meta["nbytes"]) // max(1, int(meta["n_leaves"]))
        hi = leaf_bytes
        lo = max(0, hi - self.speculate_window)
        if hi <= lo:
            return
        sim = self.store.dfs.cont.pool.sim
        try:
            with sim.background_phase():
                man = self.store.manifest(session)
                out = self.store.restore_window(session, lo, hi,
                                                client_node=node, man=man)
        except Exception:
            return                  # best-effort: the request still lands
        self._spec_manifests[(session, int(node))] = man
        self._speculations += 1
        self._spec_bytes += sum(int(a.nbytes) for a in out.values())

    def speculated_manifest(self, session: str, node: int) -> dict | None:
        """Collect (and consume) the manifest the speculative prefetch
        read while warming ``node`` — the foreground restore passes it as
        ``man=`` instead of re-reading the manifest KV.  None when no
        speculation reached that node."""
        return self._spec_manifests.pop((session, int(node)), None)

    def begin(self, session: str, node: int | None = None) -> int:
        """Admit one restore: route (unless the caller pins ``node``) and
        claim a slot on the target.  A demoted session is promoted back
        to the hot tier first (quota room is reserved for it — possibly
        demoting colder victims in turn)."""
        self.ensure_hot(session)
        n = self.route(session) if node is None else int(node)
        ns = self._nodes[n]
        if not ns.alive:
            raise SchedulerError(f"decode node {n} is down")
        ns.active += 1
        return n

    def end(self, session: str, node: int, nbytes: int | None = None) -> None:
        """Retire one restore: release the slot and book the session's
        bytes as resident on the node (trimming the node's book to its
        cache budget, oldest sessions first — the ClientCache mirror)."""
        ns = self._nodes[int(node)]
        ns.active = max(0, ns.active - 1)
        ns.served += 1
        if nbytes is None:
            nbytes = self._size.get(session, 0)
        self._note_resident(ns, session, int(nbytes))
        if session in self._lru:
            self._lru.move_to_end(session)

    def _note_resident(self, ns: NodeState, session: str,
                       nbytes: int) -> None:
        ns.resident_bytes -= ns.resident.pop(session, 0)
        ns.resident[session] = nbytes
        ns.resident_bytes += nbytes
        while ns.resident_bytes > self.node_cache_bytes \
                and len(ns.resident) > 1:
            _victim, vbytes = ns.resident.popitem(last=False)
            ns.resident_bytes -= vbytes

    def _drop_resident(self, session: str) -> None:
        for ns in self._nodes.values():
            ns.resident_bytes -= ns.resident.pop(session, 0)

    # ------------- bounded store (admission / eviction) -------------
    @property
    def store_bytes(self) -> int:
        """Published payload bytes the store currently holds."""
        return sum(self._size.values())

    def reserve(self, session: str, nbytes: int) -> list[str]:
        """Admission control: make room for ``nbytes`` of session payload
        under the quota by displacing store-LRU victims (never the
        incoming session itself — a republish reuses its own slot).  On a
        tiered mount with ``demote_on_evict`` victims *demote* to the
        cold tier — quota pressure spills restorable state cold instead
        of destroying it; otherwise they are evicted outright.  Returns
        the displaced session ids; raises if the session cannot fit even
        into an empty store."""
        if self.quota_bytes is None:
            return []
        if int(nbytes) > self.quota_bytes:
            # refuse upfront: evicting victims first and discovering the
            # session still cannot fit would thrash the store to empty
            raise SchedulerError(
                f"session {session!r} ({int(nbytes)} B) cannot fit the "
                f"store quota ({self.quota_bytes} B)")
        grow = int(nbytes) - self._size.get(session, 0)
        displaced: list[str] = []
        while self.store_bytes + grow > self.quota_bytes:
            victim = next((s for s in self._lru if s != session), None)
            if victim is None:
                raise SchedulerError(
                    f"session {session!r} ({int(nbytes)} B) cannot fit the "
                    f"store quota ({self.quota_bytes} B)")
            if self.demote_on_evict:
                self.demote(victim)
            else:
                self.evict(victim)
            displaced.append(victim)
        return displaced

    def evict(self, session: str) -> None:
        """Drop one session from the store — through the real pipeline
        (leaf unlinks + manifest/index KV removal), so eviction cost shows
        up in whatever phase runs it — and from every routing book."""
        self.store.evict(session)
        self._evicted_bytes += self._size.pop(session, 0)
        self._cold_size.pop(session, None)
        self._lru.pop(session, None)
        self._drop_resident(session)
        self._evictions += 1

    def demote(self, session: str) -> None:
        """Spill one session to the cold tier — through the store's
        demotion path (cold copy, manifest flip in-tx, hot unlink after
        commit), then off the hot books: it stops counting against the
        quota and holds no residency anywhere, but stays restorable."""
        nbytes = self._size.get(session, 0) or self._cold_size.get(session, 0)
        self.store.demote(session)
        self._size.pop(session, None)
        self._cold_size[session] = nbytes
        self._lru.pop(session, None)
        self._drop_resident(session)
        self._demotions += 1
        self._demoted_bytes += nbytes

    def ensure_hot(self, session: str) -> list[str]:
        """Promote a demoted session back under the quota: reserve room
        (possibly demoting colder victims in turn), pull the leaves hot
        through the store, and book it as the warmest LRU entry.  A
        session already hot is a no-op.  Returns the displaced ids."""
        nbytes = self._cold_size.get(session)
        if nbytes is None:
            return []
        displaced = self.reserve(session, nbytes)
        self.store.promote(session)
        self._cold_size.pop(session, None)
        self._size[session] = nbytes
        self._lru[session] = True
        self._lru.move_to_end(session)
        self._promotions += 1
        return displaced

    def offload(self, session: str, cache, step: int = 0,
                extra_meta: dict | None = None) -> list[str]:
        """Admit-then-publish: reserve quota room (evicting as needed),
        offload through the store, and book the new snapshot.  A republish
        drops the session's residency everywhere — readers' cached bytes
        are the previous step's."""
        nbytes = _tree_nbytes(cache)
        evicted = self.reserve(session, nbytes)
        self.store.offload(session, cache, step=step, extra_meta=extra_meta)
        self._size[session] = nbytes
        self._cold_size.pop(session, None)      # a republish lands hot
        self._lru[session] = True
        self._lru.move_to_end(session)
        self._drop_resident(session)
        return evicted

    # ------------- membership -------------
    def mark_down(self, node: int) -> None:
        """A decode node died: nothing routes there and nothing is warm
        there — its residency book and in-flight slots are gone."""
        ns = self._nodes[int(node)]
        ns.alive = False
        ns.active = 0
        ns.resident.clear()
        ns.resident_bytes = 0

    def mark_up(self, node: int) -> None:
        """A node (re)joined — cold."""
        n = int(node)
        if n in self._nodes:
            self._nodes[n].alive = True
        else:
            self._nodes[n] = NodeState(n)

    # ------------- introspection -------------
    def lru_sessions(self) -> list[str]:
        """Published sessions, coldest first."""
        return list(self._lru)

    def node_state(self, node: int) -> NodeState:
        return self._nodes[int(node)]

    def stats(self) -> dict:
        live = [ns for ns in self._nodes.values() if ns.alive]
        return {"decisions": self._decisions,
                "failovers": self._failovers,
                "speculations": self._speculations,
                "spec_bytes": self._spec_bytes,
                "evictions": self._evictions,
                "evicted_bytes": self._evicted_bytes,
                "demotions": self._demotions,
                "demoted_bytes": self._demoted_bytes,
                "promotions": self._promotions,
                "cold_sessions": len(self._cold_size),
                "cold_bytes": sum(self._cold_size.values()),
                "index_reads": self._index_reads,
                "sessions": len(self._lru),
                "store_bytes": self.store_bytes,
                "live_nodes": len(live),
                "resident_bytes": sum(ns.resident_bytes for ns in live)}

"""Failure detection and elastic replanning.

On a real pod the failure signal comes from the runtime (missing heartbeat,
collective timeout); here the detector polls engine health in the storage
pool and node liveness flags the driver sets.  The elastic policy mirrors
what the checkpoint layer supports: any new data-parallel degree that keeps
the per-replica batch integral can restart from the same checkpoint
(Checkpointer.restore_slice reads whatever ranges the new topology needs).

Event semantics: ``poll`` is level-triggered detection with edge-triggered
delivery — each engine death, node death (every engine on a server node
dead), and worker death is emitted exactly once, at the first poll that
observes it.  Repeated polls at the same step return nothing new, and a
restored engine/node re-arms its detector so a later re-failure emits a
fresh event.  The serving control plane consumes this directly:
``ServeScheduler.mark_down`` on every ``node`` event.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FailureEvent:
    kind: str          # "engine" | "node" | "worker"
    ident: int
    at_step: int


class FailureDetector:
    def __init__(self, pool=None, n_workers: int = 0) -> None:
        self.pool = pool
        self.worker_alive = [True] * n_workers
        self.events: list[FailureEvent] = []
        # O(1) dedup of already-detected failures (the old implementation
        # rescanned the whole event log per engine, O(events^2) per poll)
        self._seen: set[tuple[str, int]] = set()
        # worker events not yet delivered by a poll
        self._pending_workers: list[FailureEvent] = []

    def fail_worker(self, worker: int, step: int) -> None:
        self.worker_alive[worker] = False
        ev = FailureEvent("worker", worker, step)
        self.events.append(ev)
        self._pending_workers.append(ev)

    def restore_worker(self, worker: int) -> None:
        self.worker_alive[worker] = True

    def _node_health(self) -> dict[int, bool]:
        """server node -> any engine alive."""
        health: dict[int, bool] = {}
        for eng in self.pool.engines.values():
            health[eng.node_id] = health.get(eng.node_id, False) or eng.alive
        return health

    def poll(self, step: int) -> list[FailureEvent]:
        """Detect newly-dead storage engines, newly-dead server nodes
        (every engine on the node down), and not-yet-delivered worker
        deaths.  Each failure is emitted exactly once; a restored
        engine/node re-arms so a later re-failure is a new event."""
        out: list[FailureEvent] = []
        if self.pool is not None:
            for eid, eng in self.pool.engines.items():
                mark = ("engine", eid)
                if eng.alive:
                    self._seen.discard(mark)    # re-arm after restore
                elif mark not in self._seen:
                    self._seen.add(mark)
                    ev = FailureEvent("engine", eid, step)
                    self.events.append(ev)
                    out.append(ev)
            for nid, any_alive in sorted(self._node_health().items()):
                mark = ("node", nid)
                if any_alive:
                    self._seen.discard(mark)
                elif mark not in self._seen:
                    self._seen.add(mark)
                    ev = FailureEvent("node", nid, step)
                    self.events.append(ev)
                    out.append(ev)
        # deliver each worker death once, at the first poll at/after its
        # step (the old code re-emitted them on every poll of that step)
        still_pending: list[FailureEvent] = []
        for ev in self._pending_workers:
            if ev.at_step <= step:
                out.append(ev)
            else:
                still_pending.append(ev)
        self._pending_workers = still_pending
        return out

    @property
    def n_alive_workers(self) -> int:
        return sum(self.worker_alive)


def replan_data_parallel(global_batch: int, n_alive: int,
                         model_parallel: int = 1) -> tuple[int, int]:
    """Largest data-parallel degree <= n_alive/model_parallel that divides
    global_batch. Returns (dp, per_replica_batch)."""
    max_dp = max(1, n_alive // max(1, model_parallel))
    for dp in range(max_dp, 0, -1):
        if global_batch % dp == 0:
            return dp, global_batch // dp
    return 1, global_batch

"""RAFT-lite: the replicated metadata service.

DAOS keeps pool/container metadata in a RAFT-replicated service so that the
control plane survives server loss.  We implement the consensus core —
term-based leader election, log replication, majority commit, and a
key-value state machine — deterministically in-process.  There is no real
network: "RPCs" are method calls that respect each node's alive/partitioned
flags, which is exactly what the fault-tolerance tests need (kill the leader
mid-stream, assert the pool map survives and uncommitted entries are lost or
re-proposed, never half-applied).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class LogEntry:
    term: int
    op: tuple  # ('set', key, value) | ('del', key) | ('noop',)


class NotLeaderError(RuntimeError):
    pass


class NoQuorumError(RuntimeError):
    pass


class _Node:
    def __init__(self, node_id: int) -> None:
        self.id = node_id
        self.alive = True
        self.current_term = 0
        self.voted_for: int | None = None
        self.log: list[LogEntry] = []
        self.commit_index = -1
        self.state: dict[Any, Any] = {}
        self.applied = -1

    def apply_committed(self) -> None:
        while self.applied < self.commit_index:
            self.applied += 1
            op = self.log[self.applied].op
            if op[0] == "set":
                self.state[op[1]] = op[2]
            elif op[0] == "del":
                self.state.pop(op[1], None)

    # --- follower RPC handlers -------------------------------------------
    def request_vote(self, term: int, candidate: int,
                     last_log_index: int, last_log_term: int) -> bool:
        if not self.alive or term < self.current_term:
            return False
        if term > self.current_term:
            self.current_term, self.voted_for = term, None
        my_last_term = self.log[-1].term if self.log else -1
        up_to_date = (last_log_term, last_log_index) >= (my_last_term,
                                                         len(self.log) - 1)
        if self.voted_for in (None, candidate) and up_to_date:
            self.voted_for = candidate
            return True
        return False

    def append_entries(self, term: int, prev_index: int, prev_term: int,
                       entries: list[LogEntry], leader_commit: int) -> bool:
        if not self.alive or term < self.current_term:
            return False
        self.current_term = max(self.current_term, term)
        if prev_index >= 0:
            if prev_index >= len(self.log) or self.log[prev_index].term != prev_term:
                return False
        # truncate conflicts, append
        self.log = self.log[: prev_index + 1] + list(entries)
        self.commit_index = min(leader_commit, len(self.log) - 1)
        self.apply_committed()
        return True


class RaftGroup:
    """A replicated KV state machine with leader election."""

    def __init__(self, n_nodes: int = 3,
                 on_apply: Callable[[tuple], None] | None = None) -> None:
        if n_nodes < 1:
            raise ValueError("need at least one md replica")
        self.nodes = [_Node(i) for i in range(n_nodes)]
        self.leader_id: int | None = 0
        self.nodes[0].current_term = 1
        self.on_apply = on_apply
        self.elections = 0

    # --- membership / failures -------------------------------------------
    def fail_node(self, node_id: int) -> None:
        self.nodes[node_id].alive = False
        if self.leader_id == node_id:
            self.leader_id = None

    def restore_node(self, node_id: int) -> None:
        self.nodes[node_id].alive = True

    def quorum(self) -> int:
        return len(self.nodes) // 2 + 1

    def alive_nodes(self) -> list[_Node]:
        return [n for n in self.nodes if n.alive]

    # --- election ----------------------------------------------------------
    def elect(self) -> int:
        """Run an election among alive nodes; returns the new leader id."""
        self.elections += 1
        candidates = sorted(
            self.alive_nodes(),
            key=lambda n: (n.log[-1].term if n.log else -1, len(n.log), -n.id),
            reverse=True)
        if not candidates:
            raise NoQuorumError("no alive metadata replicas")
        for cand in candidates:
            term = max(n.current_term for n in self.alive_nodes()) + 1
            cand.current_term = term
            cand.voted_for = cand.id
            votes = 1
            last_idx = len(cand.log) - 1
            last_term = cand.log[-1].term if cand.log else -1
            for n in self.nodes:
                if n.id != cand.id and n.request_vote(term, cand.id,
                                                      last_idx, last_term):
                    votes += 1
            if votes >= self.quorum():
                self.leader_id = cand.id
                # commit a no-op in the new term to flush the pipeline
                self._replicate(LogEntry(term, ("noop",)))
                return cand.id
        raise NoQuorumError("could not elect a leader (no quorum)")

    def leader(self) -> _Node:
        if self.leader_id is None or not self.nodes[self.leader_id].alive:
            self.elect()
        assert self.leader_id is not None
        return self.nodes[self.leader_id]

    # --- replication --------------------------------------------------------
    def _replicate(self, entry: LogEntry) -> None:
        ldr = self.nodes[self.leader_id]  # type: ignore[index]
        ldr.log.append(entry)
        acks = 1
        prev_index = len(ldr.log) - 2
        prev_term = ldr.log[prev_index].term if prev_index >= 0 else -1
        for n in self.nodes:
            if n.id == ldr.id:
                continue
            ok = n.append_entries(ldr.current_term, prev_index, prev_term,
                                  [entry], ldr.commit_index)
            if not ok and n.alive:
                # follower log diverged: walk back until it accepts (full sync)
                ok = n.append_entries(ldr.current_term, -1, -1,
                                      list(ldr.log), ldr.commit_index)
            acks += 1 if ok else 0
        if acks < self.quorum():
            ldr.log.pop()
            raise NoQuorumError(
                f"entry not committed: {acks}/{len(self.nodes)} acks "
                f"(quorum {self.quorum()})")
        ldr.commit_index = len(ldr.log) - 1
        ldr.apply_committed()
        for n in self.nodes:
            if n.alive and n.id != ldr.id:
                n.commit_index = min(ldr.commit_index, len(n.log) - 1)
                n.apply_committed()
        if self.on_apply is not None:
            self.on_apply(entry.op)

    # --- public KV API -------------------------------------------------------
    def propose(self, op: tuple) -> None:
        ldr = self.leader()
        self._replicate(LogEntry(ldr.current_term, op))

    def set(self, key, value) -> None:
        self.propose(("set", key, value))

    def delete(self, key) -> None:
        self.propose(("del", key))

    def get(self, key, default=None):
        return self.leader().state.get(key, default)

    def state_snapshot(self) -> dict:
        return dict(self.leader().state)

"""MPI-I/O over the DFuse mount (ROMIO-style collective buffering).

The paper runs IOR's MPIIO backend against the DFuse mount point.  What makes
that competitive with the native DFS API (claim C3) is ROMIO's collective
buffering: ranks ship their pieces to one aggregator per node, which issues
few, large, stripe-aligned transfers — so the per-op FUSE cost is amortised
almost to nothing while the data path (daemon streaming bw, NIC, engines)
stays the same.

``write_all`` / ``read_all`` implement the two-phase exchange explicitly:
an intra-node shuffle (charged at memory/loopback cost) followed by
aggregated fuse-path transfers of ``cb_buffer_size`` each.
"""
from __future__ import annotations

from collections import defaultdict

from ..object import IOCtx
from .base import (AccessInterface, CB_BUFFER_SIZE,  # noqa: F401  (re-export)
                   FileHandle)


class MPIIOInterface(AccessInterface):
    name = "mpiio"
    profile_name = "mpiio"

    def __init__(self, dfs, cb_buffer_size: int = CB_BUFFER_SIZE,
                 via_fuse: bool = True, **kw) -> None:
        super().__init__(dfs, **kw)
        self.cb_buffer_size = cb_buffer_size
        if not via_fuse:
            self.profile_name = "mpiio-direct"

    @property
    def via_fuse(self) -> bool:
        return self.profile.via_fuse

    def make_ctx(self, client_node: int = 0, process: int = 0,
                 transfer_bytes: int = 0) -> IOCtx:
        # aggregated ops still cross fuse, but each op carries cb_buffer_size.
        # Negative process ids mark per-node aggregators (collective path):
        # the two-phase shuffle caps the aggregator's stream (~10 GB/s of
        # intra-node exchange + memcpy per byte shipped).
        return self.profile.ctx(client_node, process,
                                frag_bytes=self.cb_buffer_size,
                                proc_bw_cap=10e9 if process < 0 else 0.0)

    # ---- collective ops: (rank -> (offset, nbytes)) in one barrier ----
    def _aggregate(self, pieces: dict[int, tuple[int, int]],
                   node_of: dict[int, int]):
        """Group rank pieces by client node; each node's aggregator issues
        contiguous runs split at cb_buffer_size."""
        by_node: dict[int, list[tuple[int, int]]] = defaultdict(list)
        for rank, (off, nb) in pieces.items():
            by_node[node_of[rank]].append((off, nb))
        runs = {}
        for node, lst in by_node.items():
            lst.sort()
            merged: list[list[int]] = []
            for off, nb in lst:
                if merged and merged[-1][0] + merged[-1][1] == off:
                    merged[-1][1] += nb
                else:
                    merged.append([off, nb])
            runs[node] = merged
        return runs

    def write_all(self, handle: FileHandle,
                  pieces: dict[int, tuple[int, int]],
                  node_of: dict[int, int]) -> int:
        """Collective sized write: every rank contributes (offset, nbytes)."""
        total = 0
        for node, merged in self._aggregate(pieces, node_of).items():
            ctx = self.make_ctx(client_node=node, process=-(node + 1))
            for off, nb in merged:
                pos = 0
                while pos < nb:
                    take = min(self.cb_buffer_size, nb - pos)
                    handle.obj.write_sized(off + pos, take, ctx=ctx)
                    pos += take
                total += nb
        return total

    def read_all(self, handle: FileHandle,
                 pieces: dict[int, tuple[int, int]],
                 node_of: dict[int, int]) -> int:
        total = 0
        for node, merged in self._aggregate(pieces, node_of).items():
            ctx = self.make_ctx(client_node=node, process=-(node + 1))
            for off, nb in merged:
                pos = 0
                while pos < nb:
                    take = min(self.cb_buffer_size, nb - pos)
                    handle.obj.read_sized(off + pos, take, ctx=ctx)
                    pos += take
                total += nb
        return total

"""HDF5 over the DFuse mount.

The paper's slowest interface for file-per-process (claim C3).  The costs are
structural, not incidental, and we model each one:

* the HDF5 library serialises data into **chunks** (default here 1 MiB) —
  every chunk is a separate synchronous POSIX op through FUSE;
* B-tree / object-header metadata updates add extra small ops per dataset
  write sequence (``op_multiplier``);
* sync-on-close flushes the superblock (metadata round trips);
* every op pays the same fuse crossing as POSIX (shared daemon resource).

For the shared-file (IOR hard) case HDF5 is driven through its MPI-IO VFD,
so it inherits collective buffering — which is exactly why the paper sees
interfaces converge on shared-file: construct with ``collective=True``.
"""
from __future__ import annotations

from ..object import IOCtx
from .base import AccessInterface, H5_CHUNK  # noqa: F401  (re-export)


class HDF5Interface(AccessInterface):
    name = "hdf5"
    profile_name = "hdf5"

    def __init__(self, dfs, chunk_bytes: int = H5_CHUNK,
                 collective: bool = False, **kw) -> None:
        super().__init__(dfs, **kw)
        self.chunk_bytes = chunk_bytes
        self.collective = collective
        if collective:
            self.name = "hdf5-coll"
            self.profile_name = "hdf5-sfp"

    def make_ctx(self, client_node: int = 0, process: int = 0,
                 transfer_bytes: int = 0) -> IOCtx:
        if self.collective:
            # HDF5 -> MPI-IO VFD -> collective buffering: big aggregated ops,
            # still paying h5 library latency per op.
            return self.profile.ctx(client_node, process)
        return self.profile.ctx(client_node, process,
                                frag_bytes=self.chunk_bytes)

    def create(self, path: str, oclass=None, client_node: int = 0,
               process: int = 0, tx=None):
        h = super().create(path, oclass, client_node, process, tx=tx)
        # file-format bootstrap: superblock + root group + dataset header
        self.dfs.cont.pool.sim.record_md(3)
        h.write_sized_at(0, 2048)               # superblock/header blocks
        return h

    def close(self, handle) -> None:
        # sync-on-close: flush object headers + superblock
        self.dfs.cont.pool.sim.record_md(2)
        handle.obj.write_sized(0, 512, ctx=handle.ctx)
        handle.close()


from .mpiio import MPIIOInterface  # noqa: E402  (at bottom: avoid cycle)


class HDF5CollectiveInterface(MPIIOInterface):
    """HDF5 through its MPI-IO VFD with collective buffering — what a
    shared-file HDF5 run actually does, and why the paper sees interfaces
    converge on IOR hard.  Inherits write_all/read_all aggregation; adds
    the h5 library's per-op latency + metadata chatter."""

    name = "hdf5-coll"

    def make_ctx(self, client_node: int = 0, process: int = 0,
                 transfer_bytes: int = 0) -> IOCtx:
        ctx = super().make_ctx(client_node, process, transfer_bytes)
        ctx.lat_per_op += 70e-6
        ctx.op_multiplier = 1.5
        return ctx

"""DFuse — the POSIX mount of a DAOS container.

DFuse runs one user-space daemon per client node; every POSIX call crosses
the kernel (VFS -> FUSE -> daemon -> libdfs).  The costs (per-op kernel
crossing, 1 MiB transfer fragmentation, shared daemon stream, synchronous
chains) are the ``"posix"`` row of ``COST_PROFILES``, calibrated against
published DFuse measurements.

Two tuning levers DAOS documents, both modeled:

* ``intercept=True`` — the interception library (libioil / libpil4dfs)
  bounces data-path calls back to user space, removing the fuse data path
  while keeping POSIX semantics (the ``"posix-ioil"`` profile);
* ``cache_mode`` — dfuse client-side caching (``--enable-caching``):
  ``"readahead"`` serves re-reads from the node's page cache,
  ``"writeback"`` additionally absorbs small synchronous writes and flushes
  them as large coalesced extents.  ``"writeback"`` is what the follow-up
  paper (arXiv 2409.18682) benchmarks as dfuse caching ON.
"""
from __future__ import annotations

from .base import AccessInterface, FUSE_MAX_TRANSFER  # noqa: F401  (re-export)


class POSIXInterface(AccessInterface):
    name = "posix"
    profile_name = "posix"

    def __init__(self, dfs, intercept: bool = False,
                 cache_mode: str = "none", **kw) -> None:
        super().__init__(dfs, cache_mode=cache_mode, **kw)
        self.intercept = intercept
        if intercept:
            self.name = "posix-ioil"
            self.profile_name = "posix-ioil"
        if cache_mode != "none":
            # writeback is "the cached interface"; weaker modes get named
            self.name += ("-cached" if cache_mode == "writeback"
                          else f"-{cache_mode}")

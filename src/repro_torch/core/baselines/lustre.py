"""Lustre-like POSIX parallel filesystem baseline.

The paper's closing observation (claim C5) is that DAOS delivers *similar*
bandwidth for file-per-process and single-shared-file, "in stark contrast to
the performance standard parallel filesystems provide".  To make that
contrast visible we model the standard-filesystem behaviour DAOS escapes:

* a single metadata server (MDS) serialising opens/creates;
* OST extent locks managed by a distributed lock manager (DLM): in
  shared-file mode, writers' extents interleave across OST stripes, so each
  OST sees lock ping-pong whose cost grows with the number of writers
  sharing it (the classic IOR-hard collapse);
* per-OST streaming bandwidth comparable to the DAOS engines, so the *only*
  structural difference is POSIX consistency enforcement.

This is a closed-form model, not a byte store — it exists to draw the
comparison line in the IOR benchmark figures.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LustreModel:
    n_oss: int = 8                  # object storage servers
    osts_per_oss: int = 2
    ost_write_bw: float = 13e9      # match DAOS engine media for fairness
    ost_read_bw: float = 40e9
    oss_nic_bw: float = 12.5e9
    client_nic_bw: float = 12.5e9
    mds_op_time: float = 120e-6     # single MDS, serialised creates/opens
    lock_rt: float = 180e-6         # DLM lock revoke/grant round trip
    stripe_count_shared: int = 16   # shared file striped across all OSTs

    @property
    def n_osts(self) -> int:
        return self.n_oss * self.osts_per_oss

    def _common_bw(self, n_client_nodes: int, direction: str) -> float:
        ost_bw = self.ost_write_bw if direction == "write" else self.ost_read_bw
        media = self.n_osts * ost_bw
        server_net = self.n_oss * self.oss_nic_bw
        client_net = n_client_nodes * self.client_nic_bw
        return min(media, server_net, client_net)

    def easy_bandwidth(self, n_client_nodes: int, ppn: int,
                       block_bytes: int, direction: str) -> float:
        """File-per-process: near-ideal (modulo MDS create storm)."""
        nprocs = n_client_nodes * ppn
        total = nprocs * block_bytes
        t_io = total / self._common_bw(n_client_nodes, direction)
        t_mds = nprocs * self.mds_op_time          # create/open serialised
        return total / (t_io + t_mds)

    def hard_bandwidth(self, n_client_nodes: int, ppn: int,
                       block_bytes: int, transfer_bytes: int,
                       direction: str) -> float:
        """Single shared file: DLM extent-lock ping-pong on every OST.

        With W writers interleaving extents over S stripes, a transfer on a
        stripe whose lock another client holds pays revoke+grant before its
        data moves — the stripe's writers effectively take turns.  The
        per-stripe duty cycle is
            k_lock = t_transfer / (t_transfer + p_conflict * (W/S) * lock_rt)
        which is the classic IOR-hard collapse (10-25% of FPP bandwidth)."""
        nprocs = n_client_nodes * ppn
        total = nprocs * block_bytes
        bw = self._common_bw(n_client_nodes, direction)
        if direction == "read":
            # read locks are shared: mild overhead only
            t_io = total / bw
            return total / (t_io + nprocs * self.mds_op_time * 0.1)
        writers_per_stripe = max(1.0, nprocs / self.stripe_count_shared)
        p_conflict = 1.0 - 1.0 / writers_per_stripe
        t_transfer = transfer_bytes / self.ost_write_bw
        k_lock = t_transfer / (t_transfer
                               + p_conflict * writers_per_stripe * self.lock_rt)
        return bw * k_lock if writers_per_stripe > 1 else bw

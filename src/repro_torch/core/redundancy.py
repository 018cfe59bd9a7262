"""Replication and erasure-coding helpers (RP_k / EC_kP1).

DAOS protects objects either by full replication (RP_*) or Reed-Solomon
erasure coding (EC_kPp).  We implement XOR parity (p=1) — sufficient to
demonstrate degraded reads and rebuild, and byte-exact testable.
"""
from __future__ import annotations

import numpy as np


def xor_parity(cells: list[bytes], cell_size: int) -> bytes:
    """Parity cell = XOR of data cells, each zero-padded to cell_size."""
    acc = np.zeros(cell_size, np.uint8)
    for c in cells:
        a = np.frombuffer(c, np.uint8)
        if a.size < cell_size:
            a = np.concatenate([a, np.zeros(cell_size - a.size, np.uint8)])
        elif a.size > cell_size:
            raise ValueError("cell larger than cell_size")
        acc ^= a
    return acc.tobytes()


def reconstruct(surviving: list[bytes], parity: bytes, cell_size: int,
                lost_length: int) -> bytes:
    """Recover the single lost data cell from the k-1 survivors + parity."""
    acc = np.frombuffer(xor_parity(surviving, cell_size), np.uint8).copy()
    p = np.frombuffer(parity, np.uint8)
    if p.size < cell_size:
        p = np.concatenate([p, np.zeros(cell_size - p.size, np.uint8)])
    acc ^= p
    return acc[:lost_length].tobytes()


class DataLossError(IOError):
    """Unprotected data lived only on a failed engine."""

"""Multipart transfer: large leaves split into concurrent parts.

A single-stream read of a large leaf is bound by one client NIC and one
process's completion chain no matter how deep its submission queue runs.
The multipart path (the smart_open multipart-upload idiom, inverted for
both directions) splits any transfer above ``MP_THRESHOLD`` into
``MP_PART_BYTES`` parts, fans the parts across client nodes via the
interface's topology-derived placement, issues each part on its handle's
async submission queue, and commits them *in order* — part ``i`` never
lands after part ``i+1`` has been acknowledged, so a reader that observes
any prefix boundary observes a dense prefix.

Parts are planned on stripe-cell boundaries wherever possible (the default
part size equals the default stripe cell), so each part's IODs map onto
whole cells through ``CellPlanner`` and no engine sees a torn cell from
two parts of the same transfer.

The handles fan out with ``iface.dup`` — one namespace lookup for the
whole transfer, per-part placement (the MPI_File_open pattern) — and every
byte still moves through the unified interface -> cache -> planner ->
object pipeline, so multipart composes with caching, transactions and
every interface the matrix knows.
"""
from __future__ import annotations

import numpy as np

MIB = 1 << 20

#: transfers at or above this size take the multipart path
MP_THRESHOLD = 4 * MIB
#: target part size (equals the default stripe cell: parts stay
#: cell-aligned, so no two parts share an engine-side cell)
MP_PART_BYTES = 1 * MIB


def plan_parts(nbytes: int, part_bytes: int = MP_PART_BYTES
               ) -> list[tuple[int, int]]:
    """Split ``[0, nbytes)`` into ``[lo, hi)`` parts of ``part_bytes``."""
    if nbytes <= 0:
        return []
    step = max(1, int(part_bytes))
    return [(lo, min(lo + step, nbytes)) for lo in range(0, nbytes, step)]


def should_multipart(nbytes: int, threshold: int = MP_THRESHOLD) -> bool:
    """Whether a transfer is worth fanning out: below the threshold the
    per-part setup (dup, extra flows) costs more than the parallelism
    buys."""
    return int(nbytes) >= int(threshold) and threshold > 0


def _fan_handles(iface, parts, open_first, placer, tx=None):
    """One handle per part: a single namespace op for the first, dup'd
    descriptors with per-part placement for the rest."""
    handles = []
    h0 = None
    for i, _ in enumerate(parts):
        node, proc = placer(i)
        if h0 is None:
            h0 = open_first(node, proc)
            handles.append(h0)
        else:
            handles.append(iface.dup(h0, client_node=node, process=proc,
                                     tx=tx))
    return handles


def multipart_read(iface, path: str, nbytes: int, *, offset: int = 0,
                   part_bytes: int = MP_PART_BYTES,
                   placer=None) -> np.ndarray:
    """Read ``[offset, offset+nbytes)`` of ``path`` as concurrent parts
    fanned across client nodes, reassembled in order."""
    placer = placer or iface.place_writer
    parts = plan_parts(nbytes, part_bytes)
    handles = _fan_handles(
        iface, parts,
        lambda node, proc: iface.open(path, client_node=node, process=proc),
        placer)
    events = [h.read_at_async(offset + lo, hi - lo)
              for (lo, hi), h in zip(parts, handles)]
    out = np.zeros(nbytes, np.uint8)
    # ordered commit: parts retire in submission order
    for (lo, hi), ev in zip(parts, events):
        out[lo:hi] = ev.wait()
    return out


def multipart_write_at(iface, handle, offset: int, data, *, tx=None,
                       part_bytes: int = MP_PART_BYTES,
                       placer=None) -> int:
    """Write ``data`` at ``offset`` of an *already-open* handle as
    concurrent parts fanned across client nodes (``iface.dup`` per part —
    no namespace traffic at all).

    Without a transaction the parts retire in order before returning.
    Under ``tx=`` the parts stay queued on their handles' submission
    queues: the tx commit barrier is the completion point, so parts from
    successive calls (e.g. the leaves of one checkpoint step) pipeline
    together until the epoch turns visible.
    """
    placer = placer or iface.place_writer
    buf = np.asarray(
        np.frombuffer(data, np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.ascontiguousarray(data).view(np.uint8).reshape(-1))
    parts = plan_parts(buf.size, part_bytes)
    events = []
    for i, (lo, hi) in enumerate(parts):
        node, proc = placer(i)
        h = iface.dup(handle, client_node=node, process=proc, tx=tx)
        events.append((h, h.write_at_async(offset + lo, buf[lo:hi])))
    if tx is None:
        for h, ev in events:    # ordered commit
            ev.wait()
            h.close()
    return int(buf.size)


def multipart_write(iface, path: str, data, *, offset: int = 0,
                    oclass=None, tx=None,
                    part_bytes: int = MP_PART_BYTES,
                    placer=None) -> int:
    """Write ``data`` at ``offset`` of ``path`` as concurrent parts with
    ordered commit.  Creates the file (first part's placement owns the
    namespace op); ``tx=`` stages every part under one epoch."""
    placer = placer or iface.place_writer
    buf = np.asarray(
        np.frombuffer(data, np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.ascontiguousarray(data).view(np.uint8).reshape(-1))
    parts = plan_parts(buf.size, part_bytes)
    handles = _fan_handles(
        iface, parts,
        lambda node, proc: iface.create(path, oclass=oclass,
                                        client_node=node, process=proc,
                                        tx=tx),
        placer, tx=tx)
    events = [h.write_at_async(offset + lo, buf[lo:hi])
              for (lo, hi), h in zip(parts, handles)]
    for ev in events:       # ordered commit
        ev.wait()
    for h in handles:
        h.close()
    return int(buf.size)

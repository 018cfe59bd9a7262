"""Storage engine — the VOS (versioned object store) of one DAOS target.

An engine owns one socket's worth of media and stores *versioned extents*:
key = (container, object, dkey, akey), each holding one record per epoch.
Readers resolve the highest epoch <= their snapshot, which is what makes the
transaction layer (epoch commit/abort) trivial and torn-checkpoint-proof.

Real bytes are stored (correctness is exercised for real: read-after-write,
checksum verification, replication/EC reconstruction).  For multi-GiB
benchmark sweeps, ``materialize=False`` keeps only (length, checksum) so the
flow accounting stays exact without holding 100 GiB in RAM.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from . import integrity

GIB = 1 << 30
Key = tuple  # (cont_label, oid, dkey, akey)


class EngineFailedError(IOError):
    pass


class NoSpaceError(IOError):
    pass


class NotFoundError(KeyError):
    pass


@dataclasses.dataclass
class Record:
    epoch: int
    length: int
    csum: int
    data: bytes | None  # None when not materialised


class Engine:
    """One DAOS engine (target). Thread-safe enough for the event-queue use:
    python dict ops are atomic under the GIL and each key is written by one
    client in our workloads."""

    def __init__(self, engine_id: int, node_id: int,
                 capacity_bytes: int = 6 * 256 * GIB,
                 materialize: bool = True) -> None:
        self.id = engine_id
        self.node_id = node_id
        self.capacity = capacity_bytes
        self.materialize_default = materialize
        self.alive = True
        self.used = 0
        self.flushed_epoch = 0   # client write-back durability watermark
        self._store: dict[Key, dict[int, Record]] = {}
        # cheap per-object version tokens for cache revalidation: a
        # monotonic counter per (container, object), bumped by every
        # mutation.  A timeout-coherence client compares the token it
        # remembered at fill time against the current one — one tiny RPC
        # (HWProfile.reval_op_time) instead of a full re-fetch.
        self._obj_tokens: dict[tuple, int] = {}
        # per-extent sub-tokens: the same counters broken down by subkey
        # ((dkey, akey) — for arrays that is ("arr", cell_no), i.e. one
        # counter per stripe cell).  A page-granular cache revalidates
        # only the cells its pages overlap, so a foreign write elsewhere
        # in the object no longer drops untouched pages.
        self._sub_tokens: dict[tuple, dict[tuple, int]] = {}

    # -- health -------------------------------------------------------------
    def fail(self) -> None:
        self.alive = False

    def restore(self) -> None:
        self.alive = True

    def _check(self) -> None:
        if not self.alive:
            raise EngineFailedError(f"engine {self.id} is down")

    # -- version tokens (cache revalidation) ----------------------------------
    def _bump_token(self, key: Key) -> None:
        k = (key[0], key[1])
        self._obj_tokens[k] = self._obj_tokens.get(k, 0) + 1
        sub = self._sub_tokens.setdefault(k, {})
        sub[key[2:]] = sub.get(key[2:], 0) + 1

    def version_token(self, cont_label, oid) -> int:
        """Current version token of one object on this engine (0 if the
        object was never touched here).  Counters only grow, so equality
        with a remembered token proves no intervening mutation."""
        self._check()
        return self._obj_tokens.get((cont_label, oid), 0)

    def extent_token(self, cont_label, oid, subkeys) -> int:
        """Sum of this engine's sub-tokens over ``subkeys`` (an iterable of
        (dkey, akey) pairs).  Same monotonicity argument as
        :meth:`version_token`, restricted to the touched extent: equality
        proves no mutation landed inside it, while mutations elsewhere in
        the object leave it unchanged."""
        self._check()
        sub = self._sub_tokens.get((cont_label, oid))
        if not sub:
            return 0
        return sum(sub.get(s, 0) for s in subkeys)

    # -- data path ------------------------------------------------------------
    @staticmethod
    def _to_bytes(data) -> bytes:
        if isinstance(data, np.ndarray):
            return np.ascontiguousarray(data).tobytes()
        return bytes(data)

    def update(self, key: Key, data, epoch: int,
               csum: int | None = None, materialize: bool | None = None) -> int:
        """Write one record at an epoch. Returns stored checksum."""
        self._check()
        raw = self._to_bytes(data)
        if csum is None:
            csum = integrity.checksum(raw)
        mat = self.materialize_default if materialize is None else materialize
        versions = self._store.setdefault(key, {})
        old = versions.get(epoch)
        if old is not None:
            self.used -= old.length
        if self.used + len(raw) > self.capacity:
            raise NoSpaceError(
                f"engine {self.id}: {self.used + len(raw)} > {self.capacity}")
        versions[epoch] = Record(epoch, len(raw), csum,
                                 raw if mat else None)
        self.used += len(raw)
        self._bump_token(key)
        return csum

    def update_hole(self, key: Key, length: int, epoch: int) -> None:
        """Record a length-only (non-materialised) extent — used by the
        synthetic benchmark path. Counts against capacity but stores no
        payload bytes in RAM."""
        self._check()
        versions = self._store.setdefault(key, {})
        old = versions.get(epoch)
        if old is not None:
            self.used -= old.length
        if self.used + length > self.capacity:
            raise NoSpaceError(
                f"engine {self.id}: {self.used + length} > {self.capacity}")
        versions[epoch] = Record(epoch, length, 0, None)
        self.used += length
        self._bump_token(key)

    def fetch(self, key: Key, max_epoch: float = float("inf"),
              verify: bool = True) -> Record:
        """Read the newest record visible at max_epoch."""
        self._check()
        versions = self._store.get(key)
        if not versions:
            raise NotFoundError(key)
        visible = [e for e in versions if e <= max_epoch]
        if not visible:
            raise NotFoundError((key, max_epoch))
        rec = versions[max(visible)]
        if verify and rec.data is not None:
            integrity.verify(rec.data, rec.csum,
                             where=f"engine{self.id}:{key}")
        return rec

    def exists(self, key: Key, max_epoch: float = float("inf")) -> bool:
        versions = self._store.get(key)
        return bool(versions) and any(e <= max_epoch for e in versions)

    def punch(self, key: Key, epoch: int | None = None) -> None:
        """Delete a record (one epoch) or the whole key history."""
        self._check()
        versions = self._store.get(key)
        if not versions:
            return
        if epoch is None:
            self.used -= sum(r.length for r in versions.values())
            del self._store[key]
            self._bump_token(key)
        elif epoch in versions:
            self.used -= versions[epoch].length
            del versions[epoch]
            if not versions:
                del self._store[key]
            self._bump_token(key)

    def punch_epoch(self, epoch: int) -> int:
        """Drop every record staged at exactly `epoch` (tx abort). Returns
        number of records dropped."""
        self._check()
        n = 0
        for key in list(self._store):
            if epoch in self._store[key]:
                self.punch(key, epoch)
                n += 1
        return n

    def mark_flushed(self, epoch: int) -> None:
        """Advance the write-back durability watermark: every record this
        engine holds at epochs <= ``epoch`` is known persistent (client
        caches call this when they flush coalesced extents)."""
        self._check()
        self.flushed_epoch = max(self.flushed_epoch, int(epoch))

    # -- enumeration (rebuild, DFS readdir) -----------------------------------
    def keys(self, prefix: tuple = ()) -> Iterator[Key]:
        self._check()
        for k in list(self._store):
            if k[: len(prefix)] == prefix:
                yield k

    def records(self, key: Key) -> dict[int, Record]:
        self._check()
        return dict(self._store.get(key, {}))

    # -- introspection ----------------------------------------------------------
    def stats(self) -> dict:
        return {"id": self.id, "node": self.node_id, "alive": self.alive,
                "used_bytes": self.used, "capacity": self.capacity,
                "n_keys": len(self._store),
                "flushed_epoch": self.flushed_epoch}

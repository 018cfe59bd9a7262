"""The cold object-store backend — the ``cold://`` mount scheme.

An S3-like capacity tier: blobs keyed by path, living *outside* the
engines (cold bytes never count against DAOS media), reached through a
shared gateway whose cost shape is the inverse of the engines' — a large
per-request time-to-first-byte, a modest per-connection stream rate, and
an aggregate gateway cap (the ``HWProfile.cold_*`` constants, charged
through ``IOSim.record_cold``).  Cheap, slow, effectively unbounded.

The store is *not transactional*: a PUT is durable when it returns, there
are no epochs to stage under and nothing to punch on abort.  Mounts that
need atomicity (the tiering layer's demotions) copy bytes here first and
flip their manifest inside a hot-tier epoch tx — see
``interfaces/tiered.py``.  Opening a cold handle with ``tx=`` is
therefore an error, not a silent downgrade.

``ColdObject`` duck-types just enough of ``ArrayObject`` for the shared
``FileHandle`` machinery (sync and async paths, multipart fan-out) to run
unmodified: reads/writes charge cold flows, and the planner shim reports
no touched engines (submission windows key on ``None`` — qd is pinned to
1 by the sync profile anyway, the S3 request/response model).
"""
from __future__ import annotations

import numpy as np

from ..object import DEFAULT_CTX, IOCtx
from .base import AccessInterface


class _ColdPlan:
    """Planner shim: cold blobs have no stripe layout and touch no
    engines (submission-queue windows degenerate to the shared key)."""

    def touched_engines(self, offset: int, nbytes: int,
                        write: bool = False) -> set[int]:
        return set()


_COLD_PLAN = _ColdPlan()


class ColdStore:
    """The blob namespace behind the gateway, one per pool.

    Bytes live in host memory keyed by path — deliberately outside the
    engines, so the hot tier's capacity accounting never sees cold data.
    """

    def __init__(self, pool) -> None:
        self.pool = pool
        self._blobs: dict[str, bytearray] = {}
        self.puts = 0
        self.gets = 0
        self.deletes = 0

    @classmethod
    def for_pool(cls, pool) -> "ColdStore":
        store = getattr(pool, "_cold_store", None)
        if store is None:
            store = cls(pool)
            pool._cold_store = store
        return store

    @property
    def used_bytes(self) -> int:
        return sum(len(b) for b in self._blobs.values())

    def keys(self) -> list[str]:
        return sorted(self._blobs)

    def has(self, key: str) -> bool:
        return key in self._blobs

    def size(self, key: str) -> int:
        return len(self._blobs.get(key, b""))

    def delete(self, key: str) -> None:
        self.deletes += 1
        del self._blobs[key]

    def stats(self) -> dict:
        return {"blobs": len(self._blobs), "used_bytes": self.used_bytes,
                "puts": self.puts, "gets": self.gets,
                "deletes": self.deletes}


class ColdObject:
    """One blob, shaped like the slice of ``ArrayObject`` that
    ``FileHandle`` drives: offset reads/writes, sized variants, punch."""

    def __init__(self, store: ColdStore, key: str) -> None:
        self.store = store
        self.key = key

    # -- shims for the shared FileHandle machinery ---------------------------
    def _layout(self):
        return None

    def _planner(self, _lay) -> _ColdPlan:
        return _COLD_PLAN

    @property
    def size(self) -> int:
        return self.store.size(self.key)

    # -- data ops ------------------------------------------------------------
    def _charge(self, ctx: IOCtx, direction: str, nbytes: int) -> None:
        self.store.pool.sim.record_cold(
            client_node=ctx.client_node, process=ctx.process,
            direction=direction, nbytes=int(nbytes))

    def _blob_for_write(self, end: int) -> bytearray:
        blob = self.store._blobs.get(self.key)
        if blob is None:
            blob = self.store._blobs[self.key] = bytearray()
        if len(blob) < end:
            blob.extend(b"\0" * (end - len(blob)))
        return blob

    @staticmethod
    def _as_bytes(data) -> bytes:
        if isinstance(data, (bytes, bytearray, memoryview)):
            return bytes(data)
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1).tobytes()

    def write(self, offset: int, data, ctx: IOCtx = DEFAULT_CTX) -> int:
        raw = self._as_bytes(data)
        blob = self._blob_for_write(offset + len(raw))
        blob[offset:offset + len(raw)] = raw
        self.store.puts += 1
        self._charge(ctx, "write", len(raw))
        return len(raw)

    def read(self, offset: int, size: int,
             ctx: IOCtx = DEFAULT_CTX) -> np.ndarray:
        blob = self.store._blobs.get(self.key, b"")
        out = np.zeros(int(size), np.uint8)
        chunk = bytes(blob[offset:offset + int(size)])
        out[:len(chunk)] = np.frombuffer(chunk, np.uint8)
        self.store.gets += 1
        self._charge(ctx, "read", size)
        return out

    def write_sized(self, offset: int, nbytes: int,
                    ctx: IOCtx = DEFAULT_CTX) -> int:
        self._blob_for_write(offset + int(nbytes))
        self.store.puts += 1
        self._charge(ctx, "write", nbytes)
        return int(nbytes)

    def read_sized(self, offset: int, nbytes: int,
                   ctx: IOCtx = DEFAULT_CTX) -> int:
        self.store.gets += 1
        self._charge(ctx, "read", nbytes)
        return int(nbytes)

    def punch(self, ctx: IOCtx = DEFAULT_CTX) -> None:
        if self.store.has(self.key):
            self.store.delete(self.key)
        self._charge(ctx, "write", 0)


class ColdObjectInterface(AccessInterface):
    """The ``cold://`` mount: blob PUT/GET semantics on the shared
    ``FileHandle`` surface.

    No namespace (prefix listing instead of directories, like S3
    ``list-objects``), no cache tier (the gateway is the cache boundary),
    no transactions.  ``readdir(prefix)`` returns each blob's full key
    remainder below the prefix — joining prefix and name reconstructs the
    key, which is what manifest-less GC sweeps need."""

    name = "cold"
    profile_name = "cold"
    has_namespace = False
    tier_role = "cold"

    def __init__(self, dfs, cache_mode: str = "none", **kw) -> None:
        if cache_mode != "none":
            raise ValueError(
                "cold:// has no client cache tier: the gateway is the "
                "cache boundary (mount a tiered:// store for a hot tier)")
        super().__init__(dfs, cache_mode="none", **kw)
        self.store = ColdStore.for_pool(dfs.cont.pool)

    # -- namespace ops (blob semantics) --------------------------------------
    def _no_tx(self, tx) -> None:
        if tx is not None:
            raise ValueError(
                "cold:// objects are not transactional: a PUT is durable "
                "when it returns and there is no epoch to stage under — "
                "copy under a hot-tier tx and flip the manifest instead "
                "(what tiered:// demotion does)")

    def create(self, path: str, oclass=None, client_node: int = 0,
               process: int = 0, tx=None):
        # oclass is accepted and ignored: blobs are not striped
        self._no_tx(tx)
        ctx = self.make_ctx(client_node, process)
        return self._handle(ColdObject(self.store, path), ctx, client_node)

    def open(self, path: str, client_node: int = 0, process: int = 0,
             tx=None):
        return self.create(path, None, client_node, process, tx=tx)

    def stat(self, path: str, client_node: int = 0, process: int = 0) -> dict:
        if not self.store.has(path):
            raise FileNotFoundError(path)
        return {"type": "object", "size": self.store.size(path)}

    def unlink(self, path: str, client_node: int = 0,
               process: int = 0) -> None:
        if not self.store.has(path):
            raise FileNotFoundError(path)
        ColdObject(self.store, path).punch(
            ctx=self.make_ctx(client_node, process))

    def mkdir(self, path: str) -> None:
        pass        # prefixes need no creation (S3 has no directories)

    def readdir(self, path: str) -> list[str]:
        prefix = "/" + str(path).strip("/")
        prefix = prefix.rstrip("/") + "/"
        return sorted(k[len(prefix):] for k in self.store.keys()
                      if k.startswith(prefix))

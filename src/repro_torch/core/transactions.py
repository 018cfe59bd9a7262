"""Epoch-based transactions (daos_tx_*).

A transaction allocates an epoch above the committed watermark; writes made
under it are stored versioned-at-epoch but invisible to readers (whose
snapshot is the committed epoch) until commit.  Abort punches the staged
epoch.  This is what makes checkpoints atomic: a writer that dies mid-save
leaves only invisible garbage, never a torn checkpoint.
"""
from __future__ import annotations


class TxStateError(RuntimeError):
    pass


class Transaction:
    def __init__(self, container) -> None:
        self.container = container
        self.epoch = container.alloc_epoch()
        self.state = "open"            # open | committed | aborted
        self.touched_engines: set[int] = set()
        # (name, offset, nbytes, ctx) per array write staged under this
        # epoch: the commit replays these as coherence notifications —
        # staged data only *changes* what readers see at commit, so that
        # is when foreign caches must drop/destale the extents (the
        # staging-time notification they also get can only make them
        # refetch still-current pre-commit bytes)
        self.write_log: list[tuple] = []
        # submission queues of handles opened under this tx: the commit
        # barrier drains them (queued IODs must hit the engines before the
        # epoch turns visible); an abort discards their unexecuted ops
        self.subqueues: list = []

    # -- write-side helpers (objects call these through the handle) ----------
    def touch(self, engine_id: int) -> None:
        self.touched_engines.add(engine_id)

    def register_subq(self, sq) -> None:
        """Attach a handle's submission queue to this tx's barriers."""
        if sq not in self.subqueues:
            self.subqueues.append(sq)

    def write_array(self, obj, offset: int, data, ctx=None) -> int:
        self._check_open()
        lay = obj._layout()
        for t in lay.targets:
            self.touch(t)
        kw = {"ctx": ctx} if ctx is not None else {}
        n = obj.write(offset, data, epoch=self.epoch, **kw)
        self.write_log.append((obj.name, offset, n, ctx))
        return n

    def write_sized(self, obj, offset: int, nbytes: int, ctx=None) -> int:
        """Sized (synthetic-payload) write staged under this tx's epoch."""
        self._check_open()
        lay = obj._layout()
        for t in lay.targets:
            self.touch(t)
        kw = {"ctx": ctx} if ctx is not None else {}
        obj.write_sized(offset, nbytes, epoch=self.epoch, **kw)
        self.write_log.append((obj.name, offset, nbytes, ctx))
        return nbytes

    def kv_batch(self, obj, ctx=None, qd=None):
        """Open a pipelined KV window staged under this tx's epoch.

        The batch registers itself in ``subqueues``: the commit barrier
        drains it exactly as it drains extent submission queues, and abort
        discards its unexecuted tail."""
        from .object import DEFAULT_CTX, KVBatch
        self._check_open()
        return KVBatch(obj, ctx=DEFAULT_CTX if ctx is None else ctx,
                       tx=self, qd=qd)

    def put_kv(self, obj, dkey, akey, value, ctx=None) -> None:
        self._check_open()
        for eid in obj._replicas_for(dkey):
            self.touch(eid)
        kw = {"ctx": ctx} if ctx is not None else {}
        obj.put(dkey, akey, value, epoch=self.epoch, **kw)

    def read_array(self, obj, offset: int, size: int, ctx=None):
        """Reads inside the tx see the tx's own writes."""
        kw = {"ctx": ctx} if ctx is not None else {}
        return obj.read(offset, size, epoch=float(self.epoch), **kw)

    def read_sized(self, obj, offset: int, nbytes: int, ctx=None) -> int:
        kw = {"ctx": ctx} if ctx is not None else {}
        return obj.read_sized(offset, nbytes, epoch=float(self.epoch), **kw)

    # -- lifecycle ------------------------------------------------------------
    def _check_open(self) -> None:
        if self.state != "open":
            raise TxStateError(f"transaction is {self.state}")

    def commit(self) -> None:
        self._check_open()
        self.container.commit_tx(self)
        self.state = "committed"

    def abort(self) -> int:
        self._check_open()
        n = self.container.abort_tx(self)
        self.state = "aborted"
        return n

    def __enter__(self) -> "Transaction":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.state == "open":
            if exc_type is None:
                self.commit()
            else:
                self.abort()

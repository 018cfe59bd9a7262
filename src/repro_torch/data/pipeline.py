"""Object-store-backed training data pipeline.

The corpus lives in the DAOS-model store as fixed-size token shards (one
array object per shard — the bulk-read pattern of the paper's IOR easy
mode).  The ``Prefetcher`` keeps `depth` shard reads in flight on an event
queue; if the next shard is late (a straggling engine), it *skips ahead* to
any shard that already landed — bounded-staleness straggler mitigation: the
training loop never stalls on one slow server.
"""
from __future__ import annotations

import numpy as np

from ..core import EventQueue
from ..core.interfaces import DFS, make_interface


def write_corpus(dfs: DFS, corpus: np.ndarray, shard_tokens: int = 65536,
                 base: str = "/data", interface: str = "dfs",
                 oclass: str | None = None) -> int:
    iface = make_interface(interface, dfs)
    try:
        dfs.mkdir(base)
    except Exception:
        pass
    n_shards = -(-corpus.size // shard_tokens)
    for s in range(n_shards):
        chunk = corpus[s * shard_tokens: (s + 1) * shard_tokens]
        h = iface.create(f"{base}/shard_{s:06d}.tok", oclass=oclass,
                         client_node=s % 8, process=s)
        h.write_at(0, chunk.astype(np.int32))
    return n_shards


class ObjectStoreDataset:
    def __init__(self, dfs: DFS, base: str = "/data",
                 interface: str = "dfs") -> None:
        self.dfs = dfs
        self.iface = make_interface(interface, dfs)
        self.base = base
        self.shards = sorted(n for n in dfs.readdir(base)
                             if n.startswith("shard_"))
        if not self.shards:
            raise FileNotFoundError(f"no shards under {base}")

    def read_shard(self, idx: int, client_node: int = 0,
                   process: int = 0) -> np.ndarray:
        name = self.shards[idx % len(self.shards)]
        h = self.iface.open(f"{self.base}/{name}", client_node=client_node,
                            process=process)
        raw = h.read_at(0, h.size)
        return np.asarray(raw).view(np.int32)

    def __len__(self) -> int:
        return len(self.shards)


class Prefetcher:
    """Keeps `depth` shard reads in flight; skips stragglers."""

    def __init__(self, ds: ObjectStoreDataset, order: list[int] | None = None,
                 depth: int = 4) -> None:
        self.ds = ds
        self.order = list(order if order is not None else range(len(ds)))
        self.depth = depth
        self.eq = EventQueue(depth=depth)
        self._inflight: list[tuple[int, object]] = []
        self._next = 0
        self.skipped: list[int] = []
        self.failed: list[int] = []
        self._fill()

    def _fill(self) -> None:
        while len(self._inflight) < self.depth and \
                self._next < len(self.order):
            idx = self.order[self._next]
            self._next += 1
            self._inflight.append(
                (idx, self.eq.submit(self.ds.read_shard, idx)))

    def get(self) -> tuple[int, np.ndarray]:
        """Next ready shard — in order if possible, any ready one if the
        head is straggling and others already completed.  A shard that
        fails to read (dead engine, lost data) is dropped and logged —
        the pipeline never stalls training for one shard."""
        while self._inflight:
            head_idx, head_ev = self._inflight[0]
            if not head_ev.test():
                for i, (idx, ev) in enumerate(self._inflight[1:], 1):
                    if ev.test():  # head is a straggler: serve a ready shard
                        self.skipped.append(head_idx)
                        self._inflight.append(self._inflight.pop(0))
                        head_idx, head_ev = self._inflight[0]
                        break
            try:
                data = head_ev.wait()
            except Exception:
                self.failed.append(head_idx)
                self._inflight.pop(0)
                self._fill()
                continue
            self._inflight.pop(0)
            self._fill()
            return head_idx, data
        raise StopIteration

    def batches(self, batch: int, seq: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        buf = np.zeros(0, np.int32)
        while True:
            while buf.size < batch * (seq + 1):
                try:
                    _, shard = self.get()
                except StopIteration:
                    return
                buf = np.concatenate([buf, shard])
            need = batch * seq
            toks = buf[:need].reshape(batch, seq)
            buf = buf[need:]
            yield {"tokens": toks.astype(np.int32)}

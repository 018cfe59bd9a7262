"""dfuse-style client-side caching tier.

The follow-up paper ("Exploring DAOS Interfaces and Performance",
arXiv 2409.18682) shows that dfuse's client-side caches are the biggest
lever on exactly the axes the original paper measures: they absorb FUSE
crossings, coalesce small synchronous writes, and short-circuit metadata
round trips.  ``ClientCache`` models one client node's cache stack:

* **page cache + readahead** — reads are served from cached pages when
  possible (a local memcpy, no engine traffic); a miss fetches a whole
  readahead window so sequential re-reads hit;
* **write-back buffering** — small synchronous writes land in the cache
  (local cost only) and are flushed as large coalesced, async extents once
  ``wb_buffer_bytes`` of dirty data accumulates (or at close/fsync);
* **dentry/metadata cache** — ``stat`` / ``open`` results are cached per
  path, skipping the namespace KV lookup and metadata round trip.

Coherence is *pluggable* (``core/coherence.py``): caches attach to their
container, and every write/punch that reaches the object layer is routed
through each attached cache's ``CoherencePolicy`` — eager ``broadcast``
invalidation (foreign epoch advance drops the object's pages,
last-writer-wins), dfuse-style ``timeout`` leases revalidated against
engine version tokens, or ``off`` (no cache is created at all).  This
module owns only the *mechanisms* (entries, intervals, dirty tracking,
dropping/trimming); the coherence *decisions* live in the policy.

The cache sits *between* the interface layer and the unified I/O pipeline
(``iopath``): ``FileHandle`` routes through it when the interface was built
with ``cache_mode != "none"``.  Hits are charged to the simulation as
cache-local flows (``IOSim.record_local``) — client memory bandwidth and a
page-cache syscall cost, no fabric or engine time.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from .coherence import BroadcastPolicy, CoherencePolicy, object_token

MIB = 1 << 20
# per-RPC issue overhead for daemon-originated I/O (write-back flusher,
# async readahead): native libdaos, regardless of the mount's interface
DAEMON_LAT_PER_OP = 1e-6

#: Recognised cache modes, weakest to strongest (mirrors dfuse knobs:
#: ``none`` = direct I/O, ``readahead`` = data/attr caching read-side only
#: (writes are written through but populate the cache), ``writeback`` =
#: full caching incl. write-back buffering).
CACHE_MODES = ("none", "readahead", "writeback")


@dataclasses.dataclass
class CacheStats:
    read_hits: int = 0
    read_misses: int = 0
    readahead_bytes: int = 0     # prefetched beyond what was asked for
    wb_writes: int = 0           # writes absorbed by the write-back buffer
    wb_bytes: int = 0
    flushes: int = 0             # coalesced flush extents issued
    flush_bytes: int = 0
    dentry_hits: int = 0
    dentry_misses: int = 0
    invalidations: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def hit_rate(self) -> float:
        n = self.read_hits + self.read_misses
        return self.read_hits / n if n else 0.0


# ---------------- interval bookkeeping ----------------
def _sub_interval(ivs: list[list[int]], s: int, e: int) -> None:
    """Remove [s, e) from a sorted list of disjoint intervals."""
    if e <= s:
        return
    out: list[list[int]] = []
    for a, b in ivs:
        if b <= s or a >= e:         # disjoint: keep
            out.append([a, b])
            continue
        if a < s:                    # head survives
            out.append([a, s])
        if e < b:                    # tail survives
            out.append([e, b])
    ivs[:] = out


def _clip(ivs: list[list[int]], s: int, e: int) -> list[list[int]]:
    """The parts of the intervals that fall inside [s, e)."""
    return [[max(a, s), min(b, e)] for a, b in ivs
            if max(a, s) < min(b, e)]


def _overlaps(ivs: list[list[int]], s: int, e: int) -> bool:
    return any(max(a, s) < min(b, e) for a, b in ivs)


def _add_interval(ivs: list[list[int]], s: int, e: int) -> None:
    """Insert [s, e) into a sorted list of disjoint intervals, merging."""
    if e <= s:
        return
    out: list[list[int]] = []
    placed = False
    for a, b in ivs:
        if b < s or a > e:           # disjoint (adjacency merges)
            if a > e and not placed:
                out.append([s, e])
                placed = True
            out.append([a, b])
        else:                        # overlap/adjacent: absorb
            s, e = min(s, a), max(e, b)
    if not placed:
        out.append([s, e])
    out.sort()
    ivs[:] = out


def _covers(ivs: list[list[int]], s: int, e: int) -> bool:
    if e <= s:
        return True
    for a, b in ivs:
        if a <= s < b:
            return e <= b
    return False


def _total(ivs: list[list[int]]) -> int:
    return sum(b - a for a, b in ivs)


class _ObjEntry:
    """Cached state for one object: bytes (real path) or extents (sized)."""

    __slots__ = ("obj", "sized", "data", "valid", "dirty", "ctx", "tx",
                 "lease", "pver", "pstale")

    def __init__(self, obj, sized: bool) -> None:
        self.obj = obj
        self.sized = sized
        self.data: np.ndarray | None = None if sized else np.zeros(0, np.uint8)
        self.valid: list[list[int]] = []
        self.dirty: list[list[int]] = []
        self.ctx = None              # last IOCtx, used for flush/evict
        self.tx = None               # open Transaction the dirty data is
                                     # staged under (epoch atomicity)
        # per-page coherence bookkeeping (timeout leases / version tokens;
        # page index -> value, page size owned by the ClientCache)
        self.lease: dict[int, float] = {}   # sim time of last validation
        self.pver: dict[int, int] = {}      # extent token at validation
        self.pstale: dict[int, float] = {}  # first foreign write seen

    def ensure(self, end: int) -> None:
        if self.data is not None and self.data.size < end:
            grown = np.zeros(end, np.uint8)
            grown[: self.data.size] = self.data
            self.data = grown


class ClientCache:
    """Per-client-node cache over the unified I/O pipeline."""

    def __init__(self, client_node: int = 0, mode: str = "writeback",
                 page_bytes: int = MIB, readahead_pages: int = 8,
                 wb_buffer_bytes: int = 16 * MIB,
                 capacity_bytes: int = 1024 * MIB,
                 policy: CoherencePolicy | None = None,
                 invalidation: str = "page",
                 readahead_async: bool = False) -> None:
        if mode not in CACHE_MODES:
            raise ValueError(f"cache mode {mode!r}; known: {CACHE_MODES}")
        if invalidation not in ("page", "object"):
            raise ValueError(f"invalidation granularity {invalidation!r}; "
                             "known: ('page', 'object')")
        self.client_node = client_node
        self.mode = mode
        self.page_bytes = page_bytes
        self.readahead_pages = readahead_pages
        # ra_async mount option: prefetch beyond the demand range is issued
        # as background flows that overlap with compute (IOSim bg debt)
        # instead of riding the caller's serial chain
        self.readahead_async = bool(readahead_async)
        self.wb_buffer_bytes = wb_buffer_bytes
        self.capacity_bytes = capacity_bytes
        self.policy = policy if policy is not None else BroadcastPolicy()
        # "object" recovers the pre-page-granular behaviour (any foreign
        # write drops the whole entry) — kept as a mount option so the
        # coherence bench can quantify what page granularity buys (CO5)
        self.invalidation = invalidation
        self.sim = None              # set by Container.attach_cache
        self.stats = CacheStats()
        self._entries: OrderedDict[str, _ObjEntry] = OrderedDict()
        self._dentries: dict[str, dict] = {}
        self._dentry_meta: dict[str, dict] = {}   # lease/version bookkeeping

    # ---------------- internals ----------------
    def _touch(self, obj, sized: bool) -> _ObjEntry | None:
        """LRU-touch the object's entry, creating it on first use.  Returns
        None when the entry tracks the other payload kind (real vs sized) —
        the caller then bypasses the cache for this op."""
        e = self._entries.get(obj.name)
        if e is None:
            e = _ObjEntry(obj, sized)
            self._entries[obj.name] = e
        elif e.sized != sized:
            return None
        self._entries.move_to_end(obj.name)
        return e

    def _record_local(self, obj, ctx, nbytes: int, nops: int) -> None:
        obj.pool.sim.record_local(client_node=self.client_node,
                                  process=ctx.process, nbytes=nbytes,
                                  nops=nops)

    def _flush_ctx(self, ctx):
        """Write-back flushes are issued by the kernel flusher, not the
        blocked caller: async, extent-sized daemon requests (no per-call
        1 MiB fragmentation), and attributed to this cache so the
        container's invalidation broadcast skips us.  ``qd=0``: the
        flusher runs the hardware-default submission window, not the
        caller's mount ``qd`` (a sync mount's pin must not throttle its
        own daemon).  ``lat_per_op``: the caller already paid the
        interface crossing (FUSE round trip, ioctl, ...) when the page
        was buffered; the daemon issues IODs straight through libdaos,
        so its per-RPC overhead is the native one, not the mount's."""
        return dataclasses.replace(ctx, sync=False, frag_bytes=0, qd=0,
                                   lat_per_op=DAEMON_LAT_PER_OP, cache=self)

    def _bg_ctx(self, ctx):
        """Prefetch beyond the demand range under ``readahead_async``: the
        readahead daemon's own async, extent-sized requests — same shape
        as a write-back flush, opposite direction."""
        return dataclasses.replace(ctx, sync=False, frag_bytes=0, qd=0,
                                   lat_per_op=DAEMON_LAT_PER_OP, cache=self)

    def _ra_window(self, obj, offset: int, size: int) -> tuple[int, int]:
        pg = self.page_bytes
        lo = (offset // pg) * pg
        hi = -(-(offset + size) // pg) * pg + self.readahead_pages * pg
        hi = max(offset + size, min(hi, max(obj.size, offset + size)))
        return lo, hi

    def _evict_if_needed(self) -> None:
        while (sum(_total(e.valid) for e in self._entries.values())
               > self.capacity_bytes and len(self._entries) > 1):
            name, e = next(iter(self._entries.items()))
            if e.dirty:
                self._flush_entry(e)
            del self._entries[name]

    @staticmethod
    def _tx_epoch(tx) -> float | None:
        """Snapshot epoch for reads issued under an open transaction."""
        if tx is not None and getattr(tx, "state", None) == "open":
            return float(tx.epoch)
        return None

    def _retag(self, e: _ObjEntry, tx) -> None:
        """Re-associate the entry with ``tx`` without clobbering another
        transaction's staged state.  If the entry is tagged to a different
        tx that never committed, its dirty extents are flushed at *that*
        tx's epoch first (so the old tx's commit barrier has nothing left
        to lose) and its cached ranges are dropped (an abort of the old tx
        could no longer reach them once retagged) — this also stops a
        committed-epoch caller from hitting pages staged under someone
        else's open transaction."""
        old = e.tx
        if old is tx:
            return
        if old is not None and getattr(old, "state", None) != "committed":
            if e.dirty:
                self._flush_entry(e)
            e.valid = []
            e.dirty = []
        elif old is None and tx is not None and e.dirty:
            # non-tx write-back dirty bytes must NOT be adopted by the tx:
            # once tagged, a later retag-away would flush them at the TX
            # epoch (invisible until commit) and refill the page at the
            # committed epoch — leaving a poisoned clean page no commit
            # notification ever repairs.  Flush them at their natural auto
            # epoch now, before the entry joins the tx.
            self._flush_entry(e)
        e.tx = tx

    def _tx_bypass(self, e: _ObjEntry, tx, offset: int, nbytes: int) -> bool:
        """Reads under an OPEN transaction are snapshot-isolated at the tx
        epoch: the cache may only serve them the tx's own staged bytes
        (entry tagged to this tx, range fully dirty).  Anything else goes
        to the object layer at the snapshot epoch — a hit could hand the
        tx newer committed bytes, and a fill would cache HISTORICAL bytes
        under a fresh lease (current tokens, old data), unbounding the
        timeout policy's staleness."""
        return not (e.tx is tx
                    and _covers(e.dirty, offset, offset + nbytes))

    # ---------------- data path: reads ----------------
    def read(self, obj, offset: int, size: int, ctx, tx=None) -> np.ndarray:
        e = self._touch(obj, sized=False)
        if e is None:
            return obj.read(offset, size, epoch=self._tx_epoch(tx), ctx=ctx)
        self._retag(e, tx)
        snap = self._tx_epoch(tx)
        if snap is not None and self._tx_bypass(e, tx, offset, size):
            return obj.read(offset, size, epoch=snap, ctx=ctx)
        if (_covers(e.valid, offset, offset + size)
                and self.policy.validate(self, e, obj, ctx, offset, size)):
            self.stats.read_hits += 1
            self._record_local(obj, ctx, size, 1)
            return e.data[offset: offset + size].copy()
        self.stats.read_misses += 1
        e = self._touch(obj, sized=False)   # validate may have dropped it
        self._retag(e, tx)
        lo, hi = self._ra_window(obj, offset, size)
        if self.readahead_async and self._tx_epoch(tx) is None:
            # demand bytes block the caller; the rest of the window is
            # fetched off the critical path (background debt, drained by
            # think time / later foreground phases)
            raw = np.zeros(hi - lo, np.uint8)
            d0 = offset - lo
            raw[d0: d0 + size] = obj.read(offset, size, ctx=ctx)
            bctx = self._bg_ctx(ctx)
            with obj.pool.sim.background_phase():
                if lo < offset:
                    raw[:d0] = obj.read(lo, offset - lo, ctx=bctx)
                if offset + size < hi:
                    raw[d0 + size:] = obj.read(offset + size,
                                               hi - (offset + size),
                                               ctx=bctx)
        else:
            raw = obj.read(lo, hi - lo, ctx=ctx)
        e.ensure(hi)
        # don't let the backend fill clobber dirty (unflushed) bytes
        dirty_save = [(a, b, e.data[a:b].copy()) for a, b in e.dirty
                      if a < hi and b > lo]
        e.data[lo:hi] = raw
        for a, b, d in dirty_save:
            a2, b2 = max(a, lo), min(b, hi)
            e.data[a2:b2] = d[a2 - a: b2 - a]
        _add_interval(e.valid, lo, hi)
        e.ctx = ctx
        self.policy.note_fill(self, e, obj, lo, hi)
        self.stats.readahead_bytes += (hi - lo) - size
        self._evict_if_needed()
        return e.data[offset: offset + size].copy()

    def read_sized(self, obj, offset: int, nbytes: int, ctx, tx=None) -> int:
        e = self._touch(obj, sized=True)
        if e is None:
            return obj.read_sized(offset, nbytes, epoch=self._tx_epoch(tx),
                                  ctx=ctx)
        self._retag(e, tx)
        snap = self._tx_epoch(tx)
        if snap is not None and self._tx_bypass(e, tx, offset, nbytes):
            return obj.read_sized(offset, nbytes, epoch=snap, ctx=ctx)
        if (_covers(e.valid, offset, offset + nbytes)
                and self.policy.validate(self, e, obj, ctx, offset, nbytes)):
            self.stats.read_hits += 1
            self._record_local(obj, ctx, nbytes, 1)
            return nbytes
        self.stats.read_misses += 1
        e = self._touch(obj, sized=True)    # validate may have dropped it
        self._retag(e, tx)
        lo, hi = self._ra_window(obj, offset, nbytes)
        if self.readahead_async and self._tx_epoch(tx) is None:
            obj.read_sized(offset, nbytes, ctx=ctx)
            bctx = self._bg_ctx(ctx)
            with obj.pool.sim.background_phase():
                if lo < offset:
                    obj.read_sized(lo, offset - lo, ctx=bctx)
                if offset + nbytes < hi:
                    obj.read_sized(offset + nbytes, hi - (offset + nbytes),
                                   ctx=bctx)
        else:
            obj.read_sized(lo, hi - lo, ctx=ctx)
        _add_interval(e.valid, lo, hi)
        e.ctx = ctx
        self.policy.note_fill(self, e, obj, lo, hi)
        self.stats.readahead_bytes += (hi - lo) - nbytes
        self._evict_if_needed()
        return nbytes

    # ---------------- data path: writes ----------------
    @staticmethod
    def _write_through(obj, offset: int, data, ctx, tx) -> int:
        if tx is not None and getattr(tx, "state", None) == "open":
            return tx.write_array(obj, offset, data, ctx=ctx)
        return obj.write(offset, data, ctx=ctx)

    @staticmethod
    def _write_through_sized(obj, offset: int, nbytes: int, ctx, tx) -> int:
        if tx is not None and getattr(tx, "state", None) == "open":
            return tx.write_sized(obj, offset, nbytes, ctx=ctx)
        return obj.write_sized(offset, nbytes, ctx=ctx)

    def write(self, obj, offset: int, data, ctx, tx=None) -> int:
        buf = np.asarray(
            np.frombuffer(data, np.uint8)
            if isinstance(data, (bytes, bytearray, memoryview))
            else np.ascontiguousarray(data).view(np.uint8).reshape(-1))
        e = self._touch(obj, sized=False)
        if e is None:
            return self._write_through(obj, offset, buf, ctx, tx)
        self._retag(e, tx)
        n = buf.size
        if self.mode != "writeback":
            wrote = self._write_through(obj, offset, buf, ctx, tx)
            e.ensure(offset + n)
            e.data[offset: offset + n] = buf
            _add_interval(e.valid, offset, offset + n)
            e.ctx = ctx
            self._evict_if_needed()
            return wrote
        e.ensure(offset + n)
        e.data[offset: offset + n] = buf
        _add_interval(e.valid, offset, offset + n)
        _add_interval(e.dirty, offset, offset + n)
        e.ctx = ctx
        self.stats.wb_writes += 1
        self.stats.wb_bytes += n
        self._record_local(obj, ctx, n, 1)
        obj._grow(offset + n)        # size is client-visible immediately
        if _total(e.dirty) >= self.wb_buffer_bytes:
            self._flush_entry(e)
        self._evict_if_needed()
        return n

    def write_sized(self, obj, offset: int, nbytes: int, ctx, tx=None) -> int:
        e = self._touch(obj, sized=True)
        if e is None:
            return self._write_through_sized(obj, offset, nbytes, ctx, tx)
        self._retag(e, tx)
        if self.mode != "writeback":
            self._write_through_sized(obj, offset, nbytes, ctx, tx)
            _add_interval(e.valid, offset, offset + nbytes)
            e.ctx = ctx
            self._evict_if_needed()
            return nbytes
        _add_interval(e.valid, offset, offset + nbytes)
        _add_interval(e.dirty, offset, offset + nbytes)
        e.ctx = ctx
        self.stats.wb_writes += 1
        self.stats.wb_bytes += nbytes
        self._record_local(obj, ctx, nbytes, 1)
        obj._grow(offset + nbytes)
        if _total(e.dirty) >= self.wb_buffer_bytes:
            self._flush_entry(e)
        return nbytes

    # ---------------- flush ----------------
    def _flush_entry(self, e: _ObjEntry) -> None:
        if not e.dirty or e.ctx is None:
            e.dirty = []
            return
        tx = e.tx
        if tx is not None and getattr(tx, "state", None) == "aborted":
            # dirty data staged under an aborted tx must never reach the
            # engines: the epoch it belonged to has been punched
            e.dirty = []
            e.tx = None
            return
        if tx is not None and getattr(tx, "state", None) != "open":
            tx = None            # tx already closed: flush as untracked data
        fctx = self._flush_ctx(e.ctx)
        flushed = 0
        for a, b in e.dirty:
            if e.sized:
                self._write_through_sized(e.obj, a, b - a, fctx, tx)
            else:
                self._write_through(e.obj, a, e.data[a:b], fctx, tx)
            self.stats.flushes += 1
            flushed += b - a
        self.stats.flush_bytes += flushed
        e.dirty = []
        # keep e.tx while the tx is open: sibling ranks of the same tx may
        # still be flushing, and their broadcasts must not drop this entry
        # durability watermark: the engines holding this object have now
        # persisted everything up to the current committed epoch
        cont = e.obj.container
        for eid in set(e.obj._layout().targets):
            eng = e.obj.pool.engines[eid]
            if eng.alive:
                eng.mark_flushed(cont.committed_epoch)

    def flush(self, obj=None) -> None:
        """fsync/close: push pending write-back data to the engines."""
        if obj is not None:
            e = self._entries.get(obj.name)
            if e is not None:
                self._flush_entry(e)
            return
        for e in list(self._entries.values()):
            self._flush_entry(e)

    # ---------------- transaction barriers ----------------
    def flush_tx(self, tx) -> None:
        """Commit barrier: every dirty byte staged under ``tx`` must be on
        the engines *before* the commit makes the epoch visible — otherwise
        a reader could see the transaction's metadata (e.g. a checkpoint
        manifest) while its data still sits in a client buffer."""
        for e in list(self._entries.values()):
            if e.tx is tx and e.dirty:
                self._flush_entry(e)

    def drop_tx(self, tx) -> None:
        """Abort barrier: cached state staged under ``tx`` is garbage (the
        epoch was punched) — drop the whole entry, dirty and clean alike."""
        for name, e in list(self._entries.items()):
            if e.tx is tx:
                self.invalidate(name)

    # ---------------- dentry/metadata cache ----------------
    def lookup_dentry(self, path: str, process: int = 0) -> dict | None:
        d = self._dentries.get(path)
        if d is not None and self.policy.validate_dentry(
                self, path, self._dentry_meta.get(path), process):
            self.stats.dentry_hits += 1
            return dict(d)
        self.stats.dentry_misses += 1
        return None

    def put_dentry(self, path: str, dentry: dict, vobj=None) -> None:
        """Cache a namespace lookup.  ``vobj`` is the parent directory's KV
        object — its engine version token is the dentry's revalidation
        anchor under a timeout policy (piggybacked for free: the lookup
        that produced the dentry walked that object anyway)."""
        self._dentries[path] = dict(dentry)
        if vobj is not None:
            self._dentry_meta[path] = {"vobj": vobj,
                                       "vtok": object_token(vobj),
                                       "validated_at":
                                           vobj.pool.sim.clock.now}
        else:
            self._dentry_meta.pop(path, None)

    def drop_dentry(self, path: str) -> None:
        self._dentries.pop(path, None)
        self._dentry_meta.pop(path, None)

    # ---------------- coherence mechanisms (decisions live in .policy) ----
    def _page_span(self, offset: int, nbytes: int) -> tuple[int, int]:
        """Page-align an extent outward: the byte range whose pages
        [offset, offset+nbytes) touches."""
        pg = self.page_bytes
        return (offset // pg) * pg, -(-(offset + nbytes) // pg) * pg

    def pages_for(self, entry: _ObjEntry, offset: int = 0,
                  nbytes: int | None = None) -> list[int]:
        """Page indices an extent touches; with ``nbytes`` None (extent
        unknown), every page the entry knows anything about."""
        pg = self.page_bytes
        if nbytes is not None:
            return list(range(offset // pg, -(-(offset + nbytes) // pg)))
        ps: set[int] = set(entry.lease) | set(entry.pver) | set(entry.pstale)
        for ivs in (entry.valid, entry.dirty):
            for a, b in ivs:
                ps.update(range(a // pg, -(-b // pg)))
        return sorted(ps)

    def holds_page(self, entry: _ObjEntry, p: int) -> bool:
        """Whether the cache holds ANY state for page ``p`` of the entry
        (data, dirty bytes, or lease/version/stale bookkeeping) — an O(
        intervals) membership test, no page-set materialisation."""
        if p in entry.lease or p in entry.pver or p in entry.pstale:
            return True
        lo = p * self.page_bytes
        return (_overlaps(entry.valid, lo, lo + self.page_bytes)
                or _overlaps(entry.dirty, lo, lo + self.page_bytes))

    def has_dentry(self, name: str) -> bool:
        """Whether this cache holds the dentry of the path a DFS file
        object is named after (sharer-map check for punch delivery)."""
        return (name.startswith("file:")
                and name[len("file:"):] in self._dentries)

    def conflicts(self, entry: _ObjEntry, offset: int = 0,
                  nbytes: int | None = None) -> bool:
        """Whether a write to ``[offset, offset+nbytes)`` conflicts with
        state this cache holds — the extent-lock check that decides if an
        invalidation message needs delivering at all.  Page-granular
        caches conflict only when the written extent's pages overlap
        their valid/dirty ranges (disjoint-stripe sharers never
        conflict); ``invalidation="object"`` caches hold object-granular
        locks, so any extent conflicts."""
        if nbytes is None or self.invalidation == "object":
            return True
        lo, hi = self._page_span(offset, nbytes)
        return _overlaps(entry.valid, lo, hi) or _overlaps(entry.dirty,
                                                           lo, hi)

    def invalidate(self, name: str, offset: int = 0,
                   nbytes: int | None = None) -> bool:
        """Drop cached state for an object (dirty data included —
        last-writer-wins).  With an extent, only the pages overlapping
        ``[offset, offset+nbytes)`` drop; without one (punch, unlink,
        abort — or ``invalidation="object"``), the whole entry goes, plus
        the dentry of the path a DFS file object is named after.
        Returns True when something was actually dropped."""
        if nbytes is None or self.invalidation == "object":
            if name.startswith("file:"):
                self.drop_dentry(name[len("file:"):])
            if self._entries.pop(name, None) is not None:
                self.stats.invalidations += 1
                return True
            return False
        e = self._entries.get(name)
        if e is None:
            return False
        lo, hi = self._page_span(offset, nbytes)
        dropped = _overlaps(e.valid, lo, hi) or _overlaps(e.dirty, lo, hi)
        _sub_interval(e.valid, lo, hi)
        _sub_interval(e.dirty, lo, hi)
        pg = self.page_bytes
        for p in range(lo // pg, hi // pg):
            e.lease.pop(p, None)
            e.pver.pop(p, None)
            e.pstale.pop(p, None)
        if not e.valid and not e.dirty:
            self._entries.pop(name, None)   # nothing cached: retire it
        if dropped:
            self.stats.invalidations += 1
        return dropped

    def trim_to_dirty(self, name: str, offset: int = 0,
                      nbytes: int | None = None) -> None:
        """Shrink an entry's valid ranges to the dirty extents it owns —
        the sibling-rank case (same open transaction): our staged writes
        stay valid, clean pages outside them may be stale.  With an
        extent, only the pages the sibling actually wrote are trimmed;
        valid data elsewhere in the object is untouched."""
        e = self._entries.get(name)
        if e is None:
            return
        if nbytes is None or self.invalidation == "object":
            # extent unknown — or object-granular mode: the pre-PR-4
            # whole-entry behaviour (valid collapses to owned dirty)
            e.valid = [iv[:] for iv in e.dirty]
            return
        lo, hi = self._page_span(offset, nbytes)
        keep = _clip(e.dirty, lo, hi)
        _sub_interval(e.valid, lo, hi)
        for a, b in keep:
            _add_interval(e.valid, a, b)

    def drop_all(self) -> None:
        """Simulate a remount: flush pending write-back data, then forget
        every entry and dentry.  Unlike ``invalidate``, nothing is counted
        as a coherence invalidation — the cache is simply gone."""
        for e in list(self._entries.values()):
            if e.dirty:
                self._flush_entry(e)
        self._entries.clear()
        self._dentries.clear()
        self._dentry_meta.clear()

    def fence(self, keep_dirty: bool = False) -> set:
        """Epoch fence after a failure event — the anti-``drop_all``:
        NOTHING flushes.

        * ``keep_dirty=False`` (dead client node): the node is gone, so its
          leases, clean pages, dentries AND pending write-back data all die
          with it.  Returns the still-open transactions that had state
          staged here so the caller can abort them — a half-staged tx must
          never become visible (its epoch gets punched by the abort).
        * ``keep_dirty=True`` (storage-side epoch fence, e.g. an engine
          restored empty): every lease, version memory and clean page is
          dropped — remembered tokens may collide with the reset engine's
          counters, so nothing cached may be served without a re-fetch —
          but pending write-back extents survive: their owner is alive and
          will flush them.  Valid ranges collapse to the dirty extents the
          client owns (serving your own unflushed bytes is always legal).
        """
        open_txs = {e.tx for e in self._entries.values()
                    if e.tx is not None
                    and getattr(e.tx, "state", None) == "open"}
        if not keep_dirty:
            self._entries.clear()
        else:
            for name, e in list(self._entries.items()):
                e.valid = [list(iv) for iv in e.dirty]
                e.lease.clear()
                e.pver.clear()
                e.pstale.clear()
                if not e.valid and not e.dirty:
                    self._entries.pop(name, None)
        self._dentries.clear()
        self._dentry_meta.clear()
        return open_txs

    # ---------------- introspection ----------------
    def cached_bytes(self) -> int:
        return sum(_total(e.valid) for e in self._entries.values())

    def dirty_bytes(self) -> int:
        return sum(_total(e.dirty) for e in self._entries.values())

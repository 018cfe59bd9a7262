"""Pluggable client-cache coherence policies.

The follow-up paper ("Exploring DAOS Interfaces and Performance",
arXiv 2409.18682) shows that the dfuse caching knob is not a boolean: under
multi-client *write-sharing* the caching advantage inverts — beyond some
sharer count, caching OFF wins.  Modeling that requires coherence to be a
policy axis of the cache tier, not a hardcoded scheme.  Three policies:

* ``broadcast`` — a write or punch that reaches the object layer eagerly
  pushes an invalidation into every attached cache that holds the object
  (except the writer's own).  Delivery is *costed*: each message charges
  the origin process a blocking round trip and the recipient node an
  upcall (``HWProfile.coh_msg_time``/``coh_msg_bytes``) — a strict
  coherence protocol, no longer the free oracle of the original CO1
  study (set both knobs to 0 to recover it).  Invalidation is
  page-granular: only the pages overlapping the written extent drop.
* ``timeout`` — what dfuse actually does (``attr-timeout`` /
  ``dentry-timeout``): cached attrs/dentries/pages are served without any
  coherence traffic until their lease expires; an expired page is then
  *revalidated* against an engine-side version token — a cheap round trip
  (``HWProfile.reval_op_time``, no payload, no media time) that either
  renews the lease (token unchanged) or drops the page (token moved:
  someone else wrote).  Leases, tokens and staleness are all tracked
  *per page*: revalidation compares only the extent sub-tokens of the
  touched pages, so a foreign write elsewhere in the object renews
  rather than drops.  Staleness is bounded by the timeout per page.
* ``off`` — direct I/O (dfuse caching disabled): the interface layer
  creates no cache at all, so every op is byte-for-byte the uncached
  interface.  Handled in ``AccessInterface`` (there is nothing for a
  policy object to do); :func:`make_policy` returns ``None`` for it.

Mixed-policy fleets: two mounts of one container may carry *different*
policies (e.g. ``posix-cached:coherence=timeout`` readers sharing a
container with ``posix:coherence=off`` writers).  The semantics fall out
of the layering and are guaranteed here:

* **off-writers still bump engine tokens** — version tokens live on the
  engines and move on every ``update``/``update_hole``/``punch``,
  regardless of whether the writer has a cache, so timeout-policy caches
  revalidate correctly against direct-I/O writers;
* **broadcast caches still hear about off-writers** —
  ``Container.notify_write``/``notify_punch`` fire for every object-layer
  mutation; an uncached writer has ``origin=None``, so no cache mistakes
  the event for its own flush;
* **each cache applies its own policy** — one event can simultaneously
  invalidate a broadcast cache's overlapping pages (charging delivery)
  and merely mark a timeout cache's pages stale (free).

Decision vs mechanism: the *policies* here decide what a notification or
an expired lease means; the *mechanisms* (dropping pages, trimming valid
ranges to owned dirty extents, dentry eviction) stay on ``ClientCache``.
``Container.notify_write``/``notify_punch`` route every event — carrying
the touched ``(offset, nbytes)`` extent — through the attached caches'
policies; neither ``Container`` nor ``ClientCache`` hardcodes an
invalidation scheme anymore.

Version-token protocol: every engine keeps a tiny monotonic counter per
(container, object) plus per-extent sub-counters keyed by (dkey, akey) —
for arrays that is one counter per stripe cell — all bumped by
``update``/``update_hole``/``punch``; a read fill piggybacks the current
tokens onto the response for free.  Revalidation of a page compares the
remembered sub-token sum of the cells the page overlaps
(:func:`extent_token`) against the engines' current sum (counters only
grow, so any foreign mutation inside the extent moves it; mutations
outside leave it alone).  Transaction semantics are policy-independent:
the commit barrier (``flush_tx``) and abort (``drop_tx``) act on staged
cache state directly, and sibling writes of one open transaction are
never treated as foreign by any policy.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CoherenceStats:
    """Coherence *traffic* and *staleness* accounting for one policy."""
    invalidations_sent: int = 0    # broadcast messages delivered to caches
    invalidations_applied: int = 0  # messages that actually dropped pages
    revalidations: int = 0         # version-token round trips (data entries)
    reval_hits: int = 0            # lease renewed, cached data still valid
    reval_misses: int = 0          # token moved: pages dropped, re-fetch
    dentry_revalidations: int = 0  # version-token round trips (dentries)
    stale_hits: int = 0            # hits served after a foreign write
    max_staleness_s: float = 0.0   # oldest foreign-stale data ever served
    expired: int = 0               # entries dropped on expiry w/o a token

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def messages(self) -> int:
        """Total coherence traffic in messages — the CO2 metric."""
        return (self.invalidations_sent + self.revalidations
                + self.dentry_revalidations)


def object_token(obj) -> int:
    """Current engine-side version token of an object: the SUM of the live
    target engines' per-object counters.  Counters only grow, so any
    mutation (update / sized update / punch) on any shard moves the sum —
    a max would miss mutations landing on a different shard than earlier
    ones (KV dkeys hash across engines).  An engine death shrinks the sum,
    which fails conservative: the next revalidation drops the entry.  Pure
    model state — the caller charges the round trip
    (``IOSim.record_reval``) when the lookup is real traffic and not
    piggybacked on a fill."""
    tok = 0
    cont = obj.container
    for eid in set(obj._layout().targets):
        eng = obj.pool.engines[eid]
        if eng.alive:
            tok += eng.version_token(cont.label, obj.oid)
    return tok


def extent_tokens(obj, extents) -> list[int]:
    """Version tokens for a batch of byte extents with one layout/engine
    walk: each is the sum of the live target engines' sub-tokens over the
    stripe cells [lo, hi) overlaps.  Same monotonicity/conservativeness
    argument as :func:`object_token`, restricted to the extent — the
    primitive that makes revalidation page-granular (a foreign write to a
    disjoint stripe leaves it unchanged)."""
    sc = obj.stripe_cell
    cont = obj.container
    engines = [obj.pool.engines[eid] for eid in set(obj._layout().targets)
               if obj.pool.engines[eid].alive]
    out = []
    for lo, hi in extents:
        subs = [("arr", c)
                for c in range(lo // sc, max(lo // sc + 1, -(-hi // sc)))]
        out.append(sum(e.extent_token(cont.label, obj.oid, subs)
                       for e in engines))
    return out


def extent_token(obj, lo: int, hi: int) -> int:
    """Version token of one byte extent (see :func:`extent_tokens`)."""
    return extent_tokens(obj, [(lo, hi)])[0]


def _primary_live_engine(obj) -> int | None:
    for eid in obj._layout().targets:
        if obj.pool.engines[eid].alive:
            return eid
    return None


def _tx_sibling(entry, epoch) -> bool:
    """A write from a sibling rank of the same *open* transaction (shared-
    file checkpoint: many nodes, disjoint ranges, one epoch) is coordinated,
    not foreign — no policy treats it as a coherence event."""
    return (entry is not None and entry.tx is not None
            and getattr(entry.tx, "state", None) == "open"
            and getattr(entry.tx, "epoch", None) == epoch)


class CoherencePolicy:
    """Decision surface between ``Container`` notifications and one
    ``ClientCache``'s read path.  One instance per cache (policies keep
    per-cache staleness bookkeeping); stats are aggregated per interface
    by ``AccessInterface.coherence_stats``."""

    kind: str = "?"

    def __init__(self) -> None:
        self.stats = CoherenceStats()

    # ---- container-side notifications ----
    def remote_write(self, cache, name: str, epoch: int, origin,
                     now: float, offset: int = 0, nbytes: int | None = None,
                     ctx=None) -> None:
        raise NotImplementedError

    @staticmethod
    def _deliver(cache, ctx) -> None:
        """Charge one delivered revocation: the origin blocks for the ack,
        the recipient daemon pays the upcall (see IOSim.record_coherence)."""
        sim = getattr(cache, "sim", None)
        if sim is not None:
            sim.record_coherence(
                recipient_node=cache.client_node,
                origin_process=(ctx.process if ctx is not None else None))

    def punch(self, cache, name: str, origin, now: float, ctx=None) -> None:
        """Punches are destructive and rare: EVERY policy propagates them
        eagerly (serving pages of a deleted object for a lease buys
        nothing), and the revocation is a real message — counted and
        costed per sharer, under timeout leases too (a lease protocol
        cannot deliver destructive revokes for free).  The puncher's own
        cache drops locally, free."""
        if origin is cache:
            cache.invalidate(name)
            return
        if cache._entries.get(name) is None and not cache.has_dentry(name):
            return                   # not a sharer: no message to deliver
        self.stats.invalidations_sent += 1
        self._deliver(cache, ctx)
        if cache.invalidate(name):
            self.stats.invalidations_applied += 1

    # ---- client-side validation (read path) ----
    def validate(self, cache, entry, obj, ctx, offset: int,
                 size: int) -> bool:
        """May the covering pages of ``[offset, offset+size)`` be served
        as a hit?  Returning False means the caller treats the access as
        a miss (the policy may have dropped pages)."""
        return True

    def validate_dentry(self, cache, path: str, meta, process: int) -> bool:
        return True

    # ---- fill bookkeeping (no traffic: tokens piggyback on the fetch) ----
    def note_fill(self, cache, entry, obj, lo: int, hi: int) -> None:
        pass


class BroadcastPolicy(CoherencePolicy):
    """Eager push invalidation, page-granular and cost-true.  A foreign
    write drops the pages it overlaps in every sharer's cache
    (last-writer-wins, pending dirty data included); sibling ranks of one
    open transaction only get trimmed to the ranges they own inside the
    written extent; punch drops everything everywhere.  Delivery is only
    attempted at caches that actually hold the object (the engine-side
    sharer map any real protocol keeps), and each delivered message
    charges real fabric time: the origin blocks for the ack
    (``coh_msg_time`` + round trip) and the recipient daemon pays the
    upcall — the cost that makes write-sharing storms hurt in *time*, not
    just in message counts."""

    kind = "broadcast"

    def remote_write(self, cache, name, epoch, origin, now, offset=0,
                     nbytes=None, ctx=None) -> None:
        if origin is cache:
            return
        entry = cache._entries.get(name)
        if entry is None:
            return                   # not a sharer: no message to deliver
        if not cache.conflicts(entry, offset, nbytes):
            return                   # extent locks don't conflict: nothing
            #                          to revoke, no message (Lustre-style)
        if _tx_sibling(entry, epoch):
            # coordinated sibling ranks of one open transaction: the trim
            # rides the transaction's own commit barrier — not a coherence
            # message (it fires at staging AND at the commit replay, so
            # counting it would double-book), and nobody blocks on it
            cache.trim_to_dirty(name, offset, nbytes)
            return
        self.stats.invalidations_sent += 1
        # NOTE a tx-staged foreign write revokes here AND at the commit
        # replay: staged records leak into the committed view as soon as
        # the auto-epoch watermark passes them, so skipping the staging-
        # time revocation opens a real stale window (the conformance
        # harness fails if this is "optimised" away)
        self._deliver(cache, ctx)
        if cache.invalidate(name, offset, nbytes):
            self.stats.invalidations_applied += 1


class TimeoutPolicy(CoherencePolicy):
    """dfuse-style lease + revalidation, page-granular.  No traffic on
    writes; a cached page is served until ``attr_timeout`` after its last
    validation, then revalidated against the engine-side sub-tokens of
    the cells it overlaps (one batched round trip per read covers every
    expired page).  Staleness served is bounded by the timeout per page:
    a lease is only (re)granted when the token proves no foreign write
    landed inside the page since."""

    kind = "timeout"

    def __init__(self, attr_timeout: float = 1.0,
                 dentry_timeout: float | None = None) -> None:
        super().__init__()
        self.attr_timeout = float(attr_timeout)
        self.dentry_timeout = (self.attr_timeout if dentry_timeout is None
                               else float(dentry_timeout))

    @staticmethod
    def _page_tokens(cache, obj, pages) -> dict[int, int]:
        """Extent tokens for a batch of pages — one layout/engine walk via
        :func:`extent_tokens`.  Simulated cost is unchanged (tokens travel
        in one response); this is host-side efficiency on the read path."""
        pg = cache.page_bytes
        pages = list(pages)
        toks = extent_tokens(obj, [(p * pg, (p + 1) * pg) for p in pages])
        return dict(zip(pages, toks))

    # ---- notifications: bookkeeping only, no invalidation, no traffic ----
    def remote_write(self, cache, name, epoch, origin, now, offset=0,
                     nbytes=None, ctx=None) -> None:
        entry = cache._entries.get(name)
        if entry is None:
            return
        pages = cache.pages_for(entry, offset, nbytes)
        if origin is cache:
            # our own flush landed: renew the remembered per-page versions
            # so expiry revalidation doesn't treat our own write as
            # foreign — but ONLY on pages with no foreign write pending.
            # Adopting the current token over a stale-marked page would
            # swallow the foreign bump and let revalidation renew the
            # lease forever, unbounding staleness.
            renew = [p for p in pages
                     if p in entry.lease and p not in entry.pstale]
            if renew:
                entry.pver.update(self._page_tokens(cache, entry.obj,
                                                    renew))
            return
        if _tx_sibling(entry, epoch):
            return
        # only the touched pages the cache actually holds something for go
        # stale — a page with no cached state can never be served stale,
        # and marking it anyway would grow pstale without bound as
        # foreign writers stream over the rest of a large file
        for p in pages:
            if cache.holds_page(entry, p):
                entry.pstale.setdefault(p, now)

    # punch: the costed eager revoke inherited from CoherencePolicy —
    # destructive ops take no lease, and the revocation message is real
    # traffic under timeout coherence too

    # ---- read-path validation ----
    def validate(self, cache, entry, obj, ctx, offset, size) -> bool:
        sim = obj.pool.sim
        now = sim.clock.now
        pg = cache.page_bytes
        pages = range(offset // pg, -(-(offset + size) // pg))
        expired: list[int] = []
        first_touch: list[int] = []
        stale = False
        stale_age = 0.0
        for p in pages:
            granted = entry.lease.get(p)
            if granted is None:      # first touch (write-created page)
                if p not in entry.pstale:
                    first_touch.append(p)
                else:
                    # never validated AND already foreign-stale: no lease
                    # was ever granted, so there is nothing to serve under
                    # — revalidate right now (the missing token always
                    # mismatches: drop, honest miss, last-writer-wins)
                    expired.append(p)
            elif now - granted < self.attr_timeout:
                if p in entry.pstale:
                    stale = True
                    stale_age = max(stale_age, now - entry.pstale[p])
            else:
                expired.append(p)
        if first_touch or expired:
            tokens = self._page_tokens(cache, obj, first_touch + expired)
            for p in first_touch:
                entry.lease[p] = now
                entry.pver[p] = tokens[p]
        if expired:
            # one batched token lookup revalidates every expired page of
            # the read range (the tokens travel in one response)
            eng = _primary_live_engine(obj)
            self.stats.revalidations += 1
            if eng is not None:
                sim.record_reval(client_node=cache.client_node,
                                 process=ctx.process, engine=eng)
            dropped = False
            for p in expired:
                if tokens[p] == entry.pver.get(p, -1):
                    entry.lease[p] = now
                    entry.pstale.pop(p, None)
                else:
                    dropped = True
                    cache.invalidate(entry.obj.name, p * pg, pg)
            if dropped:
                self.stats.reval_misses += 1
                return False
            self.stats.reval_hits += 1
        if stale:
            self.stats.stale_hits += 1
            self.stats.max_staleness_s = max(self.stats.max_staleness_s,
                                             stale_age)
        return True

    def validate_dentry(self, cache, path, meta, process) -> bool:
        if meta is None or meta.get("vobj") is None:
            return True                      # no token provider: no lease
        vobj = meta["vobj"]
        sim = vobj.pool.sim
        now = sim.clock.now
        if now - meta["validated_at"] < self.dentry_timeout:
            return True
        eng = _primary_live_engine(vobj)
        self.stats.dentry_revalidations += 1
        if eng is not None:
            sim.record_reval(client_node=cache.client_node, process=process,
                             engine=eng)
        # the token of the *parent directory* KV object: any entry
        # create/unlink in that directory moves it (conservatively dropping
        # sibling dentries too — the weak-consistency tradeoff dfuse makes)
        if object_token(vobj) == meta["vtok"]:
            meta["validated_at"] = now
            return True
        cache.drop_dentry(path)
        return False

    def note_fill(self, cache, entry, obj, lo, hi) -> None:
        # a fill fetched current bytes for [lo, hi); the extent tokens
        # piggyback for free.  Fully refetched pages get a fresh lease
        # (stale cleared: their bytes ARE current); a partially covered
        # tail page is only leased on true first touch — granting it a
        # page-wide lease would extend the serving window of older bytes
        # in the same page, and staleness would escape the timeout bound.
        now = obj.pool.sim.clock.now
        pg = cache.page_bytes
        grant = [p for p in range(lo // pg, -(-hi // pg))
                 if (p + 1) * pg <= hi
                 or (entry.lease.get(p) is None and p not in entry.pstale)]
        tokens = self._page_tokens(cache, obj, grant) if grant else {}
        for p in grant:
            entry.lease[p] = now
            entry.pver[p] = tokens[p]
            entry.pstale.pop(p, None)


#: Mount-option surface: policy name -> constructor kwargs accepted.
POLICY_KINDS = ("broadcast", "timeout", "off")


def normalize_coherence(spec) -> dict:
    """Normalise a coherence spec (None | str | dict) into a plain dict
    ``{"policy": ..., ...kwargs}``.  ``None`` means the default
    (broadcast, the pre-refactor behaviour)."""
    if spec is None:
        return {"policy": "broadcast"}
    if isinstance(spec, str):
        spec = {"policy": spec}
    out = dict(spec)
    policy = out.setdefault("policy", "broadcast")
    if policy not in POLICY_KINDS:
        raise ValueError(f"coherence policy {policy!r}; known: {POLICY_KINDS}")
    return out


def make_policy(spec) -> CoherencePolicy | None:
    """Build a fresh per-cache policy instance from a spec.  Returns None
    for ``off`` — the interface then attaches no cache at all (direct
    I/O)."""
    spec = normalize_coherence(spec)
    kind = spec["policy"]
    if kind == "off":
        return None
    if kind == "timeout":
        return TimeoutPolicy(
            attr_timeout=spec.get("attr_timeout", spec.get("timeout", 1.0)),
            dentry_timeout=spec.get("dentry_timeout"))
    return BroadcastPolicy()

"""The tiering layer — the ``tiered://`` mount scheme.

``tiered://hot=dfs,cold=cold,policy=lru`` mounts a hot DAOS interface in
front of a cold object store.  The hot tier is the mount: every namespace
and data op delegates there, at hot cost, so a tiered mount is
byte-for-byte its hot self until something is demoted.  The cold tier
only ever holds *demoted* copies — ``keep_n``-expired checkpoint steps,
LRU-evicted serving sessions — and the store layers (``ckpt/``,
``serve/``) drive the movement through the ``demote_file`` /
``promote_file`` helpers here.

Demotion atomicity (claim T3): the cold store is not transactional, so a
demotion copies bytes cold *first*, then flips the manifest's ``tier``
field inside a hot-tier epoch tx, and unlinks the hot copy only after the
commit barrier.  A crash mid-copy leaves the manifest pointing hot with
the hot bytes intact — a torn demotion never strands the only copy, it
just wastes some cold capacity that the next demotion overwrites.
Promotion mirrors this: hot writes stage under the tx with the manifest
flip, cold unlinks happen post-commit.

Large files fan through ``core/multipart.py`` in both directions —
demotion streams parts to the gateway from multiple processes (S3
multipart upload), promotion pulls parts through the async data path.
"""
from __future__ import annotations

from ..multipart import multipart_read, multipart_write_at, should_multipart
from .base import AccessInterface
from .registry import TIER_OPTION_KEYS

#: eviction/demotion policies the tiering layer understands
TIER_POLICIES = ("lru",)


def parse_tiered_spec(rest: str) -> dict[str, str]:
    """Parse the ``rest`` of a ``tiered://`` mount into its tier spec.

    Comma-separated ``key=value`` segments where the keys are
    ``TIER_OPTION_KEYS``.  Tier values are themselves mount strings and may
    contain commas (``hot=posix-cached:timeout=1.0,readahead=4``): a
    segment whose key is not a tier option continues the previous value,
    so nested mount options need no quoting."""
    spec: dict[str, str] = {}
    current: str | None = None
    for seg in str(rest).split(","):
        key, eq, val = seg.partition("=")
        key = key.strip().lower()
        if eq and key in TIER_OPTION_KEYS:
            if key in spec:
                raise ValueError(
                    f"tiered:// mount: duplicate tier option {key!r}")
            spec[key] = val
            current = key
        elif current is not None:
            # continuation of the previous tier's mount string
            spec[current] += "," + seg
        else:
            raise ValueError(
                f"tiered:// mount: expected hot=/cold=/policy= segments, "
                f"got {seg!r}")
    if "hot" not in spec:
        raise ValueError("tiered:// mount requires hot=<mount> (e.g. "
                         "tiered://hot=dfs,cold=cold)")
    spec.setdefault("cold", "cold")
    spec.setdefault("policy", "lru")
    if spec["policy"] not in TIER_POLICIES:
        raise ValueError(f"tiered:// policy {spec['policy']!r}: known "
                         f"policies are {list(TIER_POLICIES)}")
    return spec


class TieredInterface(AccessInterface):
    """Hot DAOS mount in front of a cold object store.

    Pure delegation to the hot tier for the ``AccessInterface`` surface
    (cost profile, caches, namespace, handles) — the cold tier is reached
    only through the explicit demote/promote helpers and the read-side
    fallbacks (``stat``/``unlink`` consult cold for demoted paths).  The
    store layers detect the capability through ``tier_aware``.
    """

    name = "tiered"
    tier_aware = True

    def __init__(self, hot: AccessInterface, cold: AccessInterface,
                 policy: str = "lru") -> None:
        # deliberately no super().__init__: every inherited code path is
        # overridden to delegate, so this wrapper owns no cache/qd state
        if getattr(hot, "tier_aware", False):
            raise ValueError("tiered:// mounts do not nest: the hot tier "
                             "must be a concrete backend")
        if getattr(cold, "tier_role", None) != "cold":
            raise ValueError(
                "tiered:// cold tier must be an object-store backend "
                f"(the cold:// scheme); got {type(cold).__name__}")
        self.hot = hot
        self.cold = cold
        self.policy = policy
        self.dfs = hot.dfs
        self.has_namespace = hot.has_namespace
        self.profile_name = hot.profile_name
        self.cache_mode = hot.cache_mode
        self.coherence = hot.coherence
        self.demotions = 0
        self.demoted_bytes = 0
        self.promotions = 0
        self.promoted_bytes = 0

    # -- cost surface: the hot tier's ----------------------------------------
    @property
    def profile(self):
        return self.hot.profile

    @property
    def qd(self) -> int:
        return self.hot.qd

    @property
    def exec_qd(self) -> int:
        return self.hot.exec_qd

    def make_ctx(self, client_node: int = 0, process: int = 0,
                 transfer_bytes: int = 0):
        return self.hot.make_ctx(client_node, process, transfer_bytes)

    def kv_batch(self, obj, tx=None, client_node: int = 0, process: int = 0,
                 qd: int | None = None):
        return self.hot.kv_batch(obj, tx=tx, client_node=client_node,
                                 process=process, qd=qd)

    # -- cache tier: the hot tier's -------------------------------------------
    def cache_for(self, client_node: int):
        return self.hot.cache_for(client_node)

    def cache_stats(self) -> dict:
        return self.hot.cache_stats()

    def coherence_stats(self) -> dict:
        return self.hot.coherence_stats()

    def flush_caches(self) -> None:
        self.hot.flush_caches()

    def drop_caches(self) -> None:
        self.hot.drop_caches()

    def place_writer(self, rank: int) -> tuple[int, int]:
        return self.hot.place_writer(rank)

    # -- namespace/data ops: hot first, cold fallback for demoted paths ------
    def create(self, path: str, oclass=None, client_node: int = 0,
               process: int = 0, tx=None):
        return self.hot.create(path, oclass=oclass, client_node=client_node,
                               process=process, tx=tx)

    def open(self, path: str, client_node: int = 0, process: int = 0,
             tx=None):
        return self.hot.open(path, client_node=client_node, process=process,
                             tx=tx)

    def dup(self, handle, client_node: int = 0, process: int = 0, tx=None):
        return self.hot.dup(handle, client_node=client_node, process=process,
                            tx=tx)

    def mkdir(self, path: str) -> None:
        self.hot.mkdir(path)

    def readdir(self, path: str) -> list[str]:
        return self.hot.readdir(path)

    def stat(self, path: str, client_node: int = 0, process: int = 0) -> dict:
        try:
            d = self.hot.stat(path, client_node=client_node, process=process)
        except (FileNotFoundError, KeyError):
            d = None
        if (d is None or not d.get("size")) and self.in_cold(path):
            return {"type": "object", "size": self.cold.store.size(path),
                    "tier": "cold"}
        if d is None:
            raise FileNotFoundError(path)
        return d

    def unlink(self, path: str, client_node: int = 0,
               process: int = 0) -> None:
        found = False
        try:
            self.hot.unlink(path, client_node=client_node, process=process)
            found = True
        except (FileNotFoundError, KeyError):
            pass
        if self.in_cold(path):
            self.cold.unlink(path, client_node=client_node, process=process)
            found = True
        if not found:
            raise FileNotFoundError(path)

    # -- tier movement ---------------------------------------------------------
    def in_cold(self, path: str) -> bool:
        return self.cold.store.has(path)

    def _read_all(self, iface: AccessInterface, path: str, nbytes: int):
        nbytes = int(nbytes)
        if should_multipart(nbytes):
            return multipart_read(iface, path, nbytes)
        h = iface.open(path)
        try:
            return h.read_at(0, nbytes)
        finally:
            h.close()

    def put_cold(self, path: str, data) -> int:
        """PUT one blob on the cold tier (multipart fan when large)."""
        nbytes = len(data)
        h = self.cold.create(path)
        try:
            if should_multipart(nbytes):
                multipart_write_at(self.cold, h, 0, data)
            else:
                h.write_at(0, data)
        finally:
            h.close()
        return nbytes

    def demote_file(self, path: str, nbytes: int | None = None) -> int:
        """Copy one hot file's bytes to the cold tier.  Copy only — the
        caller flips its manifest under a tx and unlinks the hot copy
        after commit (the T3 ordering)."""
        if nbytes is None:
            nbytes = int(self.hot.stat(path)["size"])
        data = self._read_all(self.hot, path, nbytes)
        self.put_cold(path, data)
        self.demotions += 1
        self.demoted_bytes += int(nbytes)
        return int(nbytes)

    def promote_file(self, path: str, nbytes: int, oclass=None,
                     tx=None) -> int:
        """Pull one demoted blob back onto the hot tier.  Hot writes stage
        under ``tx`` (with the caller's manifest flip); the caller unlinks
        the cold copy after commit."""
        nbytes = int(nbytes)
        data = self._read_all(self.cold, path, nbytes)
        h = self.hot.create(path, oclass=oclass, tx=tx)
        try:
            if should_multipart(nbytes):
                multipart_write_at(self.hot, h, 0, data, tx=tx)
            else:
                h.write_at(0, data)
        finally:
            h.close()
        self.promotions += 1
        self.promoted_bytes += nbytes
        return nbytes

    def hot_unlink(self, path: str) -> None:
        """Best-effort hot-copy removal (post-commit demotion cleanup)."""
        try:
            self.hot.unlink(path)
        except (FileNotFoundError, KeyError):
            pass

    def cold_unlink(self, path: str) -> None:
        """Best-effort cold-copy removal (post-commit promotion cleanup)."""
        try:
            self.cold.unlink(path)
        except (FileNotFoundError, KeyError):
            pass

    def tier_stats(self) -> dict:
        return {"policy": self.policy,
                "demotions": self.demotions,
                "demoted_bytes": self.demoted_bytes,
                "promotions": self.promotions,
                "promoted_bytes": self.promoted_bytes,
                "cold": self.cold.store.stats()}

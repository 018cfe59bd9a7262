"""The paper's DAOS access mechanisms, as swappable interfaces.

``make_interface`` routes a full *mount string* through the scheme
registry (``interfaces/registry.py``, the smart_open transport idiom):

    [scheme://]rest

``daos://name[:key=val,...]``  the interface matrix below; a bare mount
                               string with no scheme (``"dfs"``,
                               ``"posix-cached:timeout=1.0"``) resolves
                               here, so every legacy name keeps working
``cold://[key=val,...]``       the S3-like cold object store
                               (``interfaces/cold.py``)
``tiered://hot=...,cold=...,policy=lru``
                               hot DAOS in front of a cold backend
                               (``interfaces/tiered.py``)

Within the ``daos`` scheme, dfuse-style *mount options* append to the
interface name after a colon, ``name:key=val,key=val`` — the knobs the
real ``dfuse --enable-caching`` / ``attr-timeout`` flags expose:

=================  =====================================================
``coherence=``     cache-coherence policy: ``broadcast`` (eager push
                   invalidation, the default), ``timeout`` (dfuse-style
                   lease + version-token revalidation) or ``off``
                   (direct I/O: no cache is created at all)
``timeout=``       shorthand: selects ``coherence=timeout`` and sets
                   both the attr and dentry timeouts (seconds)
``attr_timeout=``  data/attr lease length (implies ``coherence=timeout``)
``dentry_timeout=`` namespace lease length (implies ``coherence=timeout``)
``readahead=``     readahead window, in pages (default 8)
``wb_mib=``        write-back buffer watermark, MiB (default 16)
``page_kib=``      cache page size, KiB (default 1024)
``inval=``         invalidation granularity: ``page`` (default; a foreign
                   write drops only the pages it overlaps) or ``object``
                   (whole-entry drop — the pre-page-granular behaviour,
                   kept so the coherence bench can quantify the delta)
``qd=``            submission-queue depth: async IODs in flight per engine
                   for this mount's handles (default: the hardware
                   profile's ``queue_depth``), or ``auto`` — the solver
                   picks each (process, engine) window from measured
                   engine congestion, ramping AIMD-style instead of using
                   a mount constant.  Synchronous interfaces (posix/mpiio/
                   hdf5 and friends) are pinned to 1 — a blocking VFS
                   round trip cannot leave more than one RPC in flight,
                   which is exactly the concurrency gap the QD sweep
                   measures — and reject ``qd=auto`` outright (there is
                   no window to adapt)
``ra_async=``      ``1``/``0``: issue readahead beyond the demand range as
                   *background* flows that overlap with compute instead of
                   riding the caller's serial chain (cached mounts only)
=================  =====================================================

e.g. ``posix-cached:timeout=1.0`` is the dfuse-caching-enabled POSIX
mount with one-second attr/dentry revalidation;
``posix-cached:coherence=off`` is byte-for-byte plain ``posix``.  The
tiering keys (``hot=``/``cold=``/``policy=``) belong to ``tiered://``
mounts only and are rejected anywhere else.
"""
from .base import (COST_PROFILES, AccessInterface, CostProfile, FileHandle)
from .cold import ColdObjectInterface, ColdStore
from .dfs import DFS, DFSError, DFSInterface, ArrayInterface
from .hdf5 import HDF5CollectiveInterface, HDF5Interface
from .mpiio import MPIIOInterface
from .posix import POSIXInterface
from .registry import (TIER_OPTION_KEYS, SchemeSpec, register_scheme,
                       registered_schemes, resolve, scheme_spec, split_mount)
from .tiered import TIER_POLICIES, TieredInterface, parse_tiered_spec

MIB = 1 << 20
KIB = 1 << 10


def _num(key: str, val: str, conv):
    """Parse a numeric mount-option value with a diagnosable error."""
    try:
        out = conv(val)
    except (TypeError, ValueError):
        raise ValueError(f"mount option {key}={val!r}: expected a "
                         f"{'number' if conv is float else 'count'}") \
            from None
    if out < 0:
        raise ValueError(f"mount option {key}={val!r}: must be >= 0")
    return out


def parse_mount_options(optstr: str) -> dict:
    """``"timeout=1.0,readahead=4"`` -> constructor kwargs
    (``coherence=``/``cache_opts=``) for an AccessInterface."""
    coherence: dict = {}
    cache_opts: dict = {}
    extra: dict = {}
    for part in filter(None, optstr.split(",")):
        key, sep, val = part.partition("=")
        key = key.strip()
        if not sep:
            raise ValueError(f"mount option {part!r}: expected key=value")
        if key == "coherence":
            coherence["policy"] = val
        elif key == "timeout":
            coherence.setdefault("policy", "timeout")
            coherence["attr_timeout"] = _num(key, val, float)
            coherence["dentry_timeout"] = coherence["attr_timeout"]
        elif key in ("attr_timeout", "dentry_timeout"):
            coherence.setdefault("policy", "timeout")
            coherence[key] = _num(key, val, float)
        elif key == "readahead":
            cache_opts["readahead_pages"] = _num(key, val, int)
        elif key == "wb_mib":
            cache_opts["wb_buffer_bytes"] = int(_num(key, val, float) * MIB)
        elif key == "page_kib":
            cache_opts["page_bytes"] = int(_num(key, val, float) * KIB)
        elif key == "inval":
            # invalidation granularity: "page" (default) or "object" (the
            # pre-PR-4 whole-entry behaviour, kept for the CO5 contrast)
            cache_opts["invalidation"] = val
        elif key == "qd":
            if val == "auto":
                # adaptive depth: the solver picks the window from measured
                # engine congestion (AccessInterface rejects this on sync
                # profiles — there is no window to adapt)
                extra["qd"] = "auto"
            else:
                qd = _num(key, val, int)
                if qd < 1:
                    raise ValueError(f"mount option qd={val!r}: must be "
                                     ">= 1 (or 'auto')")
                extra["qd"] = qd
        elif key == "ra_async":
            if val not in ("0", "1", "true", "false"):
                raise ValueError(f"mount option ra_async={val!r}: "
                                 "expected 0/1/true/false")
            cache_opts["readahead_async"] = val in ("1", "true")
        elif key in TIER_OPTION_KEYS:
            # same strictness as coherence-on-uncached: silently accepting
            # hot=/cold=/policy= here would let a single-tier mount
            # masquerade as a tiered one
            raise ValueError(
                f"mount option {key!r} configures the tiering layer and is "
                "only valid on a tiered:// mount (e.g. "
                "tiered://hot=dfs,cold=cold,policy=lru); this mount has no "
                "second tier")
        else:
            raise ValueError(f"unknown mount option {key!r}")
    kw: dict = dict(extra)
    if coherence:
        kw["coherence"] = coherence
    if cache_opts:
        kw["cache_opts"] = cache_opts
    return kw


def _make_daos(rest: str, dfs: DFS) -> AccessInterface:
    """The ``daos://`` scheme: the paper's interface matrix, keyed by the
    names the IOR harness / configs use, with optional ``:key=val,...``
    mount options (see module docstring)."""
    base, _, optstr = rest.partition(":")
    kw = parse_mount_options(optstr) if optstr else {}
    table = {
        "dfs": lambda **kw: DFSInterface(dfs, **kw),
        "dfs-cached": lambda **kw: DFSInterface(dfs, cache_mode="writeback",
                                                **kw),
        "daos-array": lambda **kw: ArrayInterface(dfs, **kw),
        "posix": lambda **kw: POSIXInterface(dfs, **kw),
        "posix-ioil": lambda **kw: POSIXInterface(dfs, intercept=True, **kw),
        "posix-cached": lambda **kw: POSIXInterface(dfs,
                                                    cache_mode="writeback",
                                                    **kw),
        "posix-readahead": lambda **kw: POSIXInterface(
            dfs, cache_mode="readahead", **kw),
        "mpiio": lambda **kw: MPIIOInterface(dfs, **kw),
        "hdf5": lambda **kw: HDF5Interface(dfs, **kw),
        "hdf5-coll": lambda **kw: HDF5CollectiveInterface(dfs, **kw),
        # the cold backend is addressable by name too (benchmarks sweep
        # it like any other interface); cold:// is the canonical spelling
        "cold": lambda **kw: ColdObjectInterface(dfs, **kw),
    }
    try:
        factory = table[base]
    except KeyError:
        raise KeyError(f"unknown interface {base!r}; known: {sorted(table)}")
    return factory(**kw)


def _make_cold(rest: str, dfs: DFS) -> AccessInterface:
    """The ``cold://`` scheme: S3-like object store, optional mount
    options after the ``://`` (cache/coherence knobs are rejected by the
    backend — the gateway is the cache boundary)."""
    kw = parse_mount_options(rest) if rest else {}
    return ColdObjectInterface(dfs, **kw)


def _make_tiered(rest: str, dfs: DFS) -> AccessInterface:
    """The ``tiered://`` scheme: resolve the hot and cold tier mount
    strings recursively through the registry, then wrap them."""
    spec = parse_tiered_spec(rest)
    hot = resolve(spec["hot"], dfs)
    cold = resolve(spec["cold"], dfs)
    return TieredInterface(hot, cold, policy=spec["policy"])


register_scheme("daos", _make_daos,
                "the paper's interface matrix (bare mount strings land "
                "here)")
register_scheme("cold", _make_cold,
                "S3-like cold object store behind a shared gateway")
register_scheme("tiered", _make_tiered,
                "hot DAOS tier in front of a cold object store")


def make_interface(name: str, dfs: DFS) -> AccessInterface:
    """Factory over full mount strings: ``[scheme://]rest`` routed
    through the scheme registry.  Bare names (``"dfs"``,
    ``"posix-cached:timeout=1.0"``) resolve to the ``daos`` scheme, so
    every pre-registry mount string keeps working."""
    return resolve(name, dfs)


INTERFACE_NAMES = ["dfs", "dfs-cached", "daos-array", "posix", "posix-ioil",
                   "posix-cached", "posix-readahead", "mpiio", "hdf5",
                   "hdf5-coll"]

__all__ = ["AccessInterface", "ArrayInterface", "COST_PROFILES",
           "ColdObjectInterface", "ColdStore", "CostProfile", "DFS",
           "DFSError", "DFSInterface", "FileHandle", "HDF5Interface",
           "INTERFACE_NAMES", "MPIIOInterface", "POSIXInterface",
           "SchemeSpec", "TIER_OPTION_KEYS", "TIER_POLICIES",
           "TieredInterface", "make_interface", "parse_mount_options",
           "parse_tiered_spec", "register_scheme", "registered_schemes",
           "resolve", "scheme_spec", "split_mount"]

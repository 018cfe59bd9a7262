"""Scheme-routed backend registry — the smart_open transport idiom.

``make_interface`` used to be a hard-coded table of interface names; every
new backend meant editing the factory.  This module is the replacement: a
registry of *mount schemes*, each owning a factory that turns the rest of
the mount string into an ``AccessInterface``.  A mount string is

    [scheme://]rest

and three schemes ship built in (registered by ``interfaces/__init__``):

``daos://``     the paper's interface matrix — ``rest`` is the legacy
                ``name[:key=val,...]`` form (``dfs``, ``posix-cached:
                timeout=1.0``, ...).  Bare mount strings with no scheme
                resolve here, so every pre-registry mount string keeps
                working byte-for-byte.
``cold://``     the S3-like cold object store (``interfaces/cold.py``) —
                high request latency, modest per-connection streams,
                cheap unbounded capacity, multipart-friendly.
``tiered://``   hot DAOS in front of a cold backend
                (``interfaces/tiered.py``), e.g.
                ``tiered://hot=dfs,cold=cold,policy=lru``.

New backends call :func:`register_scheme` with their own scheme instead of
editing any factory; duplicate registration is refused (a second backend
silently capturing ``cold://`` would re-route every existing mount).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

#: mount-option keys that configure the tiering layer: on any non-tiered
#: mount they are a contradiction (there is no second tier to speak of),
#: rejected with a pointed error rather than a generic unknown-option one
TIER_OPTION_KEYS = frozenset({"hot", "cold", "policy"})


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One registered mount scheme: ``factory(rest, dfs)`` builds the
    interface from everything after ``scheme://``."""
    scheme: str
    factory: Callable
    description: str = ""


_SCHEMES: dict[str, SchemeSpec] = {}


def register_scheme(scheme: str, factory: Callable,
                    description: str = "") -> SchemeSpec:
    """Register a backend under a mount scheme.

    ``factory(rest: str, dfs) -> AccessInterface`` receives the mount
    string with ``scheme://`` stripped.  Registration is first-wins:
    re-registering an existing scheme raises (a silent override would
    re-route every mount string already using it)."""
    scheme = str(scheme).strip().lower()
    if not scheme or not scheme.replace("-", "").replace("_", "").isalnum():
        raise ValueError(f"mount scheme {scheme!r}: expected a bare "
                         "identifier (letters/digits/-/_)")
    if scheme in _SCHEMES:
        raise ValueError(
            f"mount scheme {scheme!r} is already registered "
            f"({_SCHEMES[scheme].description or 'no description'}); "
            "schemes are first-wins — pick another name")
    spec = SchemeSpec(scheme, factory, description)
    _SCHEMES[scheme] = spec
    return spec


def registered_schemes() -> list[str]:
    return sorted(_SCHEMES)


def scheme_spec(scheme: str) -> SchemeSpec | None:
    return _SCHEMES.get(scheme)


def split_mount(mount: str) -> tuple[str, str]:
    """``"tiered://hot=dfs,cold=cold"`` -> ``("tiered", "hot=dfs,...")``.
    A mount string with no ``scheme://`` is the legacy bare form and
    resolves to the ``daos`` scheme — ``split_mount("dfs") ==
    ("daos", "dfs")`` — so pre-registry callers never notice."""
    if "://" in mount:
        scheme, _, rest = mount.partition("://")
        return scheme.strip().lower(), rest
    return "daos", mount


def resolve(mount: str, dfs):
    """Route one mount string through the registry to a built interface."""
    scheme, rest = split_mount(str(mount))
    spec = _SCHEMES.get(scheme)
    if spec is None:
        raise ValueError(
            f"unknown mount scheme {scheme!r} in mount {mount!r}; "
            f"registered schemes: {registered_schemes()}")
    return spec.factory(rest, dfs)

"""Object classes and placement — the DAOS striping model.

DAOS distributes an object across *targets* (engine shards) according to its
object class: S1 places the object on one engine, S2 stripes it over two,
S4 over four, ... SX over every engine in the pool (analogous to Lustre file
striping).  Placement must be deterministic given the pool map version so that
any client can locate a shard without asking a server — we use Lamping &
Veach's jump consistent hash, which is also what gives S1/S2 their natural
load *imbalance* (the effect the paper measures).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


def jump_hash(key: int, n_buckets: int) -> int:
    """Jump consistent hash (Lamping & Veach 2014). Deterministic, minimal
    movement when n_buckets changes — the property DAOS pool maps need for
    incremental rebuild."""
    if n_buckets <= 0:
        raise ValueError("n_buckets must be positive")
    key &= (1 << 64) - 1
    b, j = -1, 0
    while j < n_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & ((1 << 64) - 1)
        j = int((b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4B5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return x ^ (x >> 31)


@dataclasses.dataclass(frozen=True)
class ObjectClass:
    """A DAOS object class: stripe width + redundancy.

    name        e.g. "S1", "S2", "SX", "RP_2GX", "EC_4P1"
    stripes     number of engine shards data is striped over (0 == all, i.e. SX)
    replicas    full-data replicas (RP_k)
    ec_data/ec_parity  erasure-coding group geometry (0 == no EC)
    """
    name: str
    stripes: int            # 0 means "X" = all engines in pool
    replicas: int = 1
    ec_data: int = 0
    ec_parity: int = 0

    def resolve_stripes(self, n_engines: int) -> int:
        k = n_engines if self.stripes == 0 else min(self.stripes, n_engines)
        return max(1, k)

    @property
    def protection_factor(self) -> float:
        """Bytes written to media per logical byte."""
        if self.ec_data:
            return (self.ec_data + self.ec_parity) / self.ec_data
        return float(self.replicas)


_REGISTRY: dict[str, ObjectClass] = {}


def register(oc: ObjectClass) -> ObjectClass:
    _REGISTRY[oc.name] = oc
    return oc


OC_S1 = register(ObjectClass("S1", 1))
OC_S2 = register(ObjectClass("S2", 2))
OC_S4 = register(ObjectClass("S4", 4))
OC_S8 = register(ObjectClass("S8", 8))
OC_SX = register(ObjectClass("SX", 0))
OC_RP_2G1 = register(ObjectClass("RP_2G1", 1, replicas=2))
OC_RP_2GX = register(ObjectClass("RP_2GX", 0, replicas=2))
OC_RP_3GX = register(ObjectClass("RP_3GX", 0, replicas=3))
OC_EC_4P1 = register(ObjectClass("EC_4P1", 4, ec_data=4, ec_parity=1))
OC_EC_8P1 = register(ObjectClass("EC_8P1", 8, ec_data=8, ec_parity=1))


def get_class(name: str) -> ObjectClass:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown object class {name!r}; known: {sorted(_REGISTRY)}")


@dataclasses.dataclass(frozen=True)
class StripeLayout:
    """Resolved placement of one object on a concrete pool map."""
    oid: int
    oclass: ObjectClass
    targets: tuple[int, ...]          # engine ids, one per (stripe × replica)
    stripe_cell: int                  # bytes per stripe cell

    @property
    def width(self) -> int:
        return len(self.targets) // max(1, self.oclass.replicas)

    def shard_for_chunk(self, chunk_no: int, replica: int = 0) -> int:
        w = self.width
        return self.targets[replica * w + (chunk_no % w)]

    def replicas_for_chunk(self, chunk_no: int) -> tuple[int, ...]:
        w = self.width
        return tuple(self.targets[r * w + (chunk_no % w)]
                     for r in range(self.oclass.replicas))


def place_object(oid: int, oclass: ObjectClass, engine_ids: Sequence[int],
                 map_version: int, stripe_cell: int = 1 << 20,
                 node_of: dict[int, int] | None = None) -> StripeLayout:
    """Deterministic placement of an object's shards on the pool's engines.

    Replicas of the same stripe are forced onto distinct engines (and distinct
    *nodes* when node_of is given and enough nodes exist) — DAOS's redundancy-
    group placement rule.
    """
    engines = list(engine_ids)
    n = len(engines)
    if n == 0:
        raise ValueError("pool has no live engines")
    k = oclass.resolve_stripes(n)
    seed = _splitmix64(oid ^ _splitmix64(map_version))
    start = jump_hash(seed, n)
    # Stripe shards are laid out round-robin from a hashed starting engine —
    # this is what creates hot spots for S1/S2 (paper claims C1/C2).
    primary = [engines[(start + i) % n] for i in range(k)]
    targets = list(primary)
    for r in range(1, oclass.replicas):
        for i in range(k):
            base = (start + i) % n
            stripe_engines = {targets[rr * k + i] for rr in range(r)}
            cand = None
            # prefer a different *node* (redundancy-group placement rule),
            # fall back to any different engine
            for prefer_other_node in (True, False):
                for shift in range(1, n + 1):
                    c = engines[(base + r * shift) % n]
                    if c in stripe_engines:
                        continue
                    if prefer_other_node and node_of and \
                            node_of[c] == node_of[primary[i]]:
                        continue
                    cand = c
                    break
                if cand is not None:
                    break
            targets.append(cand if cand is not None else primary[i])
    return StripeLayout(oid=oid, oclass=oclass, targets=tuple(targets),
                        stripe_cell=stripe_cell)


def oid_for(name: str | int, container_seq: int = 0) -> int:
    """Derive a 64-bit object id from a name (DFS path, array name, ...)."""
    if isinstance(name, int):
        return _splitmix64(name ^ _splitmix64(container_seq))
    h = 1469598103934665603  # FNV-1a 64
    for byte in name.encode():
        h = ((h ^ byte) * 1099511628211) & ((1 << 64) - 1)
    return _splitmix64(h ^ _splitmix64(container_seq))

"""Tensor tree <-> object-store serialisation: the port's storage seam.

A checkpoint is laid out the way the paper's IOR modes are:

* ``sharded`` (IOR *easy*, file-per-process): one object per host-shard of
  each leaf — the layout a 1000-host cluster writes, every host streaming
  its local shard concurrently;
* ``shared`` (IOR *hard*, single-shared-file): every leaf packed at an
  offset into ONE object; hosts write disjoint ranges.

Leaf bytes carry end-to-end checksums stored in the manifest, verified on
restore: a CUDA leaf's checksum is computed on the card by the checksum
kernel (``kernels/ops.checksum_array``), host bytes by
``core.integrity.checksum``; the two are bit-identical.  The manifest (tree
structure, dtypes, shapes, offsets, checksums) is a KV object written last,
inside the same transaction — so a torn save is invisible (no manifest at
the committed epoch => checkpoint didn't happen).

A leaf's bytes and ``{"shape", "dtype"}`` metadata are exactly what the JAX
package writes for the same values: dtype strings are numpy's names, and a
bf16 tensor crosses as its int16 bit pattern, so neither side needs
``ml_dtypes``.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..core import integrity
from ..kernels import ops as kops

# torch dtype -> numpy's name for it (what ``np.asarray(jax_leaf).dtype``
# prints) and the numpy dtype that carries its bytes on the host.
_DTYPES = {
    torch.bfloat16: ("bfloat16", np.int16),
    torch.float16: ("float16", np.float16),
    torch.float32: ("float32", np.float32),
    torch.float64: ("float64", np.float64),
    torch.int8: ("int8", np.int8),
    torch.uint8: ("uint8", np.uint8),
    torch.int16: ("int16", np.int16),
    torch.int32: ("int32", np.int32),
    torch.int64: ("int64", np.int64),
    torch.bool: ("bool", np.bool_),
}
_BY_NAME = {name: (dt, carrier) for dt, (name, carrier) in _DTYPES.items()}


@dataclasses.dataclass
class HostLeaf:
    """A leaf already copied to the host: its bytes, its metadata and, for
    a leaf that lay on the card, the checksum computed there."""
    raw: np.ndarray
    meta: dict
    csum: int | None = None


def flatten_tree(tree, prefix=""):
    """-> list of (path, leaf). Stable, explicit, json-safe paths."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(flatten_tree(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(flatten_tree(v, f"{prefix}/{i}"))
    else:
        out.append((prefix or "/", tree))
    return out


def unflatten_tree(items: dict, template):
    return _unflatten_at(items, template, "")


def _unflatten_at(items, template, prefix):
    if isinstance(template, dict):
        return {k: _unflatten_at(items, template[k], f"{prefix}/{k}")
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_at(items, v, f"{prefix}/{i}")
                for i, v in enumerate(template)]
        return type(template)(vals)
    return items[prefix or "/"]


def leaf_to_bytes(leaf, copy: bool = False) -> tuple[np.ndarray, dict]:
    """-> (uint8 bytes on the host, {"shape", "dtype"}).  A CUDA tensor is
    copied off the card; a CPU tensor's bytes are shared with it unless
    ``copy``."""
    if isinstance(leaf, HostLeaf):
        return leaf.raw, leaf.meta
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"a checkpoint leaf is a tensor, not {type(leaf)}")
    t = leaf.detach().contiguous()
    name, _ = _DTYPES[t.dtype]
    meta = {"shape": list(t.shape), "dtype": name}
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    on_host = t.device.type == "cpu"
    arr = t.cpu().numpy()
    if copy and on_host:
        arr = arr.copy()
    return arr.reshape(-1).view(np.uint8), meta


def bytes_to_leaf(raw: np.ndarray, meta: dict, device="cpu") -> torch.Tensor:
    """A tensor on ``device`` with the leaf's dtype and shape.  On the CPU
    it shares ``raw``'s buffer."""
    dtype, carrier = _BY_NAME[meta["dtype"]]
    n = int(np.prod(meta["shape"])) * np.dtype(carrier).itemsize
    t = torch.from_numpy(raw[:n].view(carrier).reshape(meta["shape"]))
    if dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def checksum_leaf(leaf) -> int:
    """A CUDA tensor's checksum from the kernel, on the card (it raises if
    the kernel cannot run; there is no host fallback); host bytes' from
    ``integrity.checksum``.  The two are bit-identical."""
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type == "cuda":
            return kops.checksum_array(leaf.detach().contiguous())
        leaf = leaf_to_bytes(leaf)[0]
    return integrity.checksum(leaf)


def card_checksum(leaf) -> int | None:
    """The checksum a leaf carries into a save or an offload: a snapshot's
    own, a CUDA tensor's from the kernel (computed on the calling thread,
    before any byte leaves the card), else None (host bytes are
    checksummed as they are written)."""
    if isinstance(leaf, HostLeaf):
        return leaf.csum
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
        return checksum_leaf(leaf)
    return None


def shard_ranges(nbytes: int, n_shards: int) -> list[tuple[int, int]]:
    """Split a leaf's byte range across writer processes (hosts)."""
    per = -(-nbytes // max(1, n_shards))
    out = []
    for i in range(n_shards):
        lo = i * per
        hi = min(nbytes, lo + per)
        if lo >= hi:
            break
        out.append((lo, hi))
    return out


def manifest_dumps(entries: dict, extra: dict | None = None) -> bytes:
    return json.dumps({"leaves": entries, **(extra or {})},
                      sort_keys=True).encode()


def manifest_loads(raw: bytes) -> dict:
    return json.loads(raw.decode())

"""Seeded weights and sub-seeds: the benchmark makes every input itself and
hands the same to the program and to the reference.

A layout is a list of ``(path, shape, init)`` in the program's tree order;
``path`` joins the tree's keys with ``/`` and ``init`` is ``("normal",
std)`` or ``("ones",)``.  Each normal leaf is drawn in one call, in the
served dtype, on the device, from a generator of its own, so that any leaf
can be made again alone (``make_leaf``) and comes out bit for bit the same.
"""
from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, *tag) -> int:
    """A 63-bit seed for one purpose, from the run's seed and a tag."""
    text = "/".join(str(t) for t in (int(seed), *tag)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tag) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *tag))
    return gen


def make_leaf(seed: int, index: int, shape, init, device,
              dtype=torch.bfloat16) -> torch.Tensor:
    if init[0] == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(0.0, float(init[1]),
                     generator=generator(device, seed, "weight", index))


def make_params(seed: int, layout, device, dtype=torch.bfloat16) -> dict:
    """The nested dict of every leaf of ``layout``."""
    tree: dict = {}
    for index, (path, shape, init) in enumerate(layout):
        *keys, last = path.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = make_leaf(seed, index, shape, init, device, dtype)
    return tree


def get(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def slices(path: str, shape):
    """The parts a leaf is compared by: one per layer of a stacked leaf
    (under a layer stack), else the whole leaf.  -> [(name, index)]."""
    if path.split("/")[0] in ("blocks", "encoder", "decoder"):
        return [(f"{path}[{i}]", i) for i in range(shape[0])]
    return [(path, Ellipsis)]

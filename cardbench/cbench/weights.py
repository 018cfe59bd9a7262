"""Seeded weights and sub-seeds: the benchmark makes every input itself and
hands the same to the program and to the reference.

A layout is a list of ``(path, shape, init)`` or ``(path, shape, init,
dtype)`` in the program's tree order; ``path`` joins the tree's keys with
``/``, ``dtype`` names a torch dtype (``"float32"``) and defaults to the
served one (bf16).  ``init`` is one of

- ``("normal", std)``: N(0, std^2);
- ``("ones",)``, ``("zeros",)``, ``("const", value)``;
- ``("uniform", lo, hi)``: U(lo, hi);
- ``("log_of_uniform", lo, hi)``: log U(lo, hi), Mamba2's ``A_log``;
- ``("softplus_inv_log_uniform", lo, hi)``: softplus^-1(dt) for dt
  log-uniform in [lo, hi] and floored at ``DT_FLOOR``, Mamba2's
  ``dt_bias`` (mamba_ssm's ``Mamba2.__init__``).

Each drawn leaf is made in one call on the device from a generator of its
own (the run's seed, ``"weight"`` and the leaf's index), so that any leaf
can be made again alone (``make_leaf``) and comes out bit for bit the same.
A normal leaf is drawn in its own dtype; the others are drawn in fp32 and
rounded once.
"""
from __future__ import annotations

import hashlib
import math

import torch

DT_FLOOR = 1e-4
# the layer stacks of the two first configurations; a configuration names
# its own under ``spec["stacks"]``
STACKS = ("blocks", "encoder", "decoder")


def sub_seed(seed: int, *tag) -> int:
    """A 63-bit seed for one purpose, from the run's seed and a tag."""
    text = "/".join(str(t) for t in (int(seed), *tag)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tag) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *tag))
    return gen


def entry(item, dtype=torch.bfloat16) -> tuple:
    """A layout entry as ``(path, shape, init, dtype)``: the dtype it
    names, else ``dtype``."""
    path, shape, init, *named = item
    return path, shape, init, getattr(torch, named[0]) if named else dtype


def make_leaf(seed: int, index: int, shape, init, device,
              dtype=torch.bfloat16) -> torch.Tensor:
    kind = init[0]
    if kind in ("ones", "zeros", "const"):
        value = float(init[1]) if kind == "const" else float(kind == "ones")
        return torch.full(shape, value, dtype=dtype, device=device)
    gen = generator(device, seed, "weight", index)
    if kind == "normal":
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, float(init[1]), generator=gen)
    lo, hi = float(init[1]), float(init[2])
    u = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == "uniform":
        x = u.uniform_(lo, hi, generator=gen)
    elif kind == "log_of_uniform":
        x = torch.log(u.uniform_(lo, hi, generator=gen))
    elif kind == "softplus_inv_log_uniform":
        dt = torch.exp(u.uniform_(math.log(lo), math.log(hi), generator=gen))
        dt = torch.clamp(dt, min=DT_FLOOR)
        x = dt + torch.log(-torch.expm1(-dt))
    else:
        raise ValueError(f"unknown initialiser {init!r}")
    return x.to(dtype)


def make_flat(seed: int, layout, device, dtype=torch.bfloat16) -> dict:
    """path -> every leaf of ``layout``, each in its entry's dtype (else
    ``dtype``)."""
    out = {}
    for index, item in enumerate(layout):
        path, shape, init, dt = entry(item, dtype)
        out[path] = make_leaf(seed, index, shape, init, device, dt)
    return out


def nested(flat: dict) -> dict:
    """The nested dict of a path -> leaf dict."""
    tree: dict = {}
    for path, leaf in flat.items():
        *keys, last = path.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def make_params(seed: int, layout, device, dtype=torch.bfloat16) -> dict:
    """The nested dict of every leaf of ``layout``."""
    return nested(make_flat(seed, layout, device, dtype))


def get(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def stacks(spec: dict) -> tuple:
    """The top-level keys whose leaves stack layers on their leading dim."""
    return tuple(spec.get("stacks", STACKS))


def slices(path: str, shape, stack_keys=STACKS):
    """The parts a leaf is compared by: one per layer of a stacked leaf
    (under one of ``stack_keys``), else the whole leaf.
    -> [(name, index)]."""
    if path.split("/")[0] in stack_keys:
        return [(f"{path}[{i}]", i) for i in range(shape[0])]
    return [(path, Ellipsis)]

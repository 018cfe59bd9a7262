"""Production meshes and sharding rules, as records.

Counterpart of the JAX package's launch/mesh.py.  The port has no
partitioner, so a mesh here is a plain record of axis names and sizes and a
sharding is a spec: a tuple with one entry a dim, each ``None``
(replicated), an axis name or a tuple of axis names, standing in for
``jax.sharding.PartitionSpec``.  The rules are the reference's, leaf for
leaf, and the dry-run reads them for the bytes each device of a mesh would
hold (``per_device_bytes``).

Mesh: (data=16, model=16) single pod / (pod=2, data=16, model=16) across two
pods, read here as grids of H100s.  The ``pod`` axis composes with ``data``
as the outer data-parallel axis; ``model`` carries TP (heads / ffn / vocab
/ experts).

Param sharding policy (per leaf, by name + trailing-dims rule):
  * TP dim over 'model' wherever the natural TP dim divides by 16
    (q-heads are pre-padded in the model so they always divide);
  * FSDP: the d_model-sized dim over ('pod','data') — params AND optimizer
    state are fully sharded;
  * small leaves (norm scales, biases, conv taps) replicated.
Stacked layer trees carry a leading L dim — specs are right-aligned.
"""
from __future__ import annotations

import dataclasses
import math

from ..tree import tree_items

Spec = tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes; ``shape`` maps one to the other."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """One card as a 1x1 (data, model) mesh."""
    return Mesh(("data", "model"), (1, 1))


MESHES = {"1x1": make_host_mesh(), "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}


def dp_axes(mesh: Mesh):
    return tuple(a for a in mesh.axis_names if a in ("pod", "data")) or None


def axis_size(mesh: Mesh, *names: str) -> int:
    return math.prod(mesh.shape[n] for n in names if n in mesh.shape)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _entry_size(mesh: Mesh, ax) -> int:
    if ax is None:
        return 1
    return axis_size(mesh, *(ax if isinstance(ax, tuple) else (ax,)))


def _spec(entries) -> Spec:
    """A spec with each one-axis tuple written as the axis name, as a
    PartitionSpec normalises it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _specs_with_path(fn, tree, prefix: str = ""):
    """The tree of ``_spec(fn(path, leaf))``."""
    if isinstance(tree, dict):
        return {k: _specs_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return _spec(fn(prefix, tree))


class ShardingRules:
    """Builds specs for params / optimizer state / batches / caches of one
    (cfg, mesh) pair.  Leaves are anything with a ``shape``: meta tensors
    or ``TensorSpec``s."""

    def __init__(self, cfg, mesh: Mesh, *,
                 fsdp: bool = True) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.tp = mesh.shape.get("model", 1)
        self.dp = dp_axes(mesh)
        self.dp_size = axis_size(mesh, "pod", "data")
        self.fsdp = fsdp

    # -------------- param rules --------------
    def _leaf_spec(self, path: str, shape: tuple) -> Spec:
        tp = self.tp
        dpx = self.dp if self.fsdp else None
        nd = len(shape)

        def right_align(*spec):
            return (None,) * (nd - len(spec)) + tuple(spec)

        last = shape[-1] if nd else 0
        second = shape[-2] if nd >= 2 else 0

        if nd <= 1 or min(shape[-2:]) == 1:
            return ()  # scalars, norm scales, biases, conv taps

        name = path.split("/")[-1]
        # --- embeddings ---
        if name == "tok":
            return right_align("model" if _div(second, tp) else None,
                               dpx if _div(last, self.dp_size) else None)
        if name == "head":
            return right_align(dpx if _div(second, self.dp_size) else None,
                               "model" if _div(last, tp) else None)
        # --- MoE experts (E, d, ff) / (E, ff, d) ---
        if "moe" in path and name in ("w_gate", "w_up"):
            return right_align("model" if _div(shape[-3], tp) else None,
                               dpx if _div(second, self.dp_size) else None,
                               None)
        if "moe" in path and name == "w_down":
            return right_align("model" if _div(shape[-3], tp) else None,
                               None,
                               dpx if _div(last, self.dp_size) else None)
        if name == "router":
            return right_align(dpx if _div(second, self.dp_size) else None,
                               None)
        # --- projections with contraction on d_model (d, out) ---
        if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in",
                    "w_branch", "w_gate_branch", "w_r", "w_i"):
            return right_align(
                dpx if _div(second, self.dp_size) else None,
                "model" if _div(last, tp) else None)
        # --- projections back to d_model (out, d) ---
        if name in ("wo", "w_down", "w_out"):
            return right_align(
                "model" if _div(second, tp) else None,
                dpx if _div(last, self.dp_size) else None)
        if name == "conv":
            return right_align(None, None)
        return ()  # default: replicated

    def param_specs(self, shapes_tree):
        return _specs_with_path(
            lambda path, s: self._leaf_spec(path, tuple(s.shape)),
            shapes_tree)

    def opt_specs(self, opt_shapes, param_specs_tree):
        """Optimizer state mirrors param specs; factored Adafactor leaves
        drop the reduced axis."""
        pspec_by_path = dict(tree_items(param_specs_tree))

        def spec_of(path, leaf):
            slot, _, rest = path.partition("/")
            base = pspec_by_path.get(rest)
            if base is None or slot == "count":
                return ()
            spec = tuple(base)
            nd = len(leaf.shape)
            if slot == "vr":      # reduced last axis
                spec = spec[:-1] if len(spec) == nd + 1 else spec
            elif slot == "vc":    # reduced second-to-last axis
                spec = (spec[:-2] + spec[-1:]) if len(spec) == nd + 1 \
                    else spec
            if len(spec) != nd:
                spec = (None,) * nd
            # drop shardings that no longer divide
            return tuple(ax if ax and dim % _entry_size(self.mesh, ax) == 0
                         else None for dim, ax in zip(leaf.shape, spec))

        return _specs_with_path(spec_of, opt_shapes)

    # -------------- batch / cache rules --------------
    def batch_specs(self, batch_shapes):
        def spec(path, s):
            if tuple(s.shape) == ():
                return ()
            if not _div(s.shape[0], self.dp_size):
                return (None,) * len(s.shape)
            return (self.dp,) + (None,) * (len(s.shape) - 1)

        return _specs_with_path(spec, batch_shapes)

    def cache_specs(self, cache_shapes):
        """Cache leaves are layer-stacked: (L, B, S, Hkv, D) etc.
        KV heads shard over 'model' when divisible, else the sequence dim
        does (flash-decode style: softmax reduces over the sharded axis)."""
        tp = self.tp

        def spec(keys, s):
            nd = len(s.shape)
            batch_ok = _div(s.shape[1], self.dp_size) if nd >= 2 else False
            bspec = self.dp if batch_ok else None
            if keys.endswith(("k", "v")) and nd == 5:
                L, B, S, H, D = s.shape
                if _div(H, tp):
                    return (None, bspec, None, "model", None)
                if _div(S, tp):
                    return (None, bspec, "model", None, None)
                return (None, bspec, None, None, None)
            if keys.endswith("state") and nd == 5:   # ssm (L,B,H,N,P)
                L, B, H, N, Pd = s.shape
                return (None, bspec, "model" if _div(H, tp) else None,
                        None, None)
            if keys.endswith(("rec_h", "rec_conv")):
                w = s.shape[-1]
                return (None,) * (nd - 1) + ("model" if _div(w, tp)
                                             else None,)
            if keys.endswith("conv") and nd == 4:     # ssm conv state
                return (None, bspec, None, None)
            return (None,) * nd

        return _specs_with_path(spec, cache_shapes)


# -------------- per-device sizes --------------

def local_shape(shape, spec: Spec, mesh: Mesh) -> tuple:
    """The shape one device holds of a leaf sharded by ``spec`` (specs are
    right-padded with ``None``, as PartitionSpecs are)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-dim // _entry_size(mesh, ax))
                 for dim, ax in zip(shape, spec))


def per_device_bytes(tree, specs, mesh: Mesh) -> int:
    """The bytes one device holds of ``tree`` (leaves with a shape and a
    dtype) sharded by the spec tree ``specs``."""
    spec_by_path = dict(tree_items(specs)) if isinstance(specs, dict) \
        else None
    total = 0
    for path, leaf in tree_items(tree):
        spec = spec_by_path[path] if spec_by_path is not None else specs
        n = math.prod(local_shape(tuple(leaf.shape), spec, mesh))
        total += n * leaf.dtype.itemsize
    return total

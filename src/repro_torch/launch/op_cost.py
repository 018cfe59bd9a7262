"""Op-level cost of an eager step: FLOPs, bytes moved and peak live bytes.

Counterpart of the JAX package's launch/hlo_cost.py.  The reference
parses the compiled HLO of a step; the port has no compiler between the
step and the card, so it counts the ops the step dispatches, one by one,
with a ``TorchDispatchMode`` (``OpCost``).  Run on the meta device, a step
at full width costs no memory and no arithmetic, only the Python of its
dispatches:

  * FLOPs: by ``torch.utils.flop_counter``'s registry, as
    ``FlopCounterMode`` counts them (an op without a formula is decomposed
    where it can be, else charged nothing).  The reference counts every
    dot and convolution; the registry counts the matmul and convolution
    ops, and the kernels' custom ops (``repro_torch::flash_fwd``,
    ``::flash_bwd``) by their own formulas, so a kernel is one unit of
    cost and the ops its CPU twin runs inside it are never seen;
  * bytes: each op that is not a view or an allocation reads its operands
    and writes its result once (eager: no op fuses with its neighbours);
  * peak live bytes: the storages the step creates, from the op that
    creates one to the moment its last reference goes (a finaliser on the
    storage object, which PyTorch keeps alive as long as the storage
    itself); storages that exist before the window are not counted;
  * a bucket: ops whose ``"region/path:op"`` matches ``bucket_re`` count
    also into ``bucket_flops`` / ``bucket_bytes``, as ``analyze(bucket_re=)``
    does, the path naming the ``with cost.region(name)`` blocks the op
    runs in.  The backward pass runs outside the forward's regions, so a
    backward op reaches the bucket by its name only.

Everything is per call of the step on one device.
"""
from __future__ import annotations

import contextlib
import re
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# size and stride queries: no op runs, FlopCounterMode skips them too
_METADATA = {_aten.sym_is_contiguous.default, _aten.is_contiguous.default,
             _aten.is_contiguous.memory_format,
             _aten.is_strides_like_format.default,
             _aten.is_non_overlapping_and_dense.default,
             _aten.size.default, _aten.sym_size.default,
             _aten.stride.default, _aten.sym_stride.default,
             _aten.storage_offset.default,
             _aten.sym_storage_offset.default, _aten.numel.default,
             _aten.sym_numel.default, _aten.dim.default,
             torch.ops.prim.layout.default}
# ops that move no bytes: allocations (their storage is tracked all the
# same) and the view a reshape of a fresh copy ends in; views are free too
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten._unsafe_view.default}
# factories that take a tensor for its shape only: they write their result
_RESULT_ONLY = {_aten.zeros_like.default, _aten.ones_like.default,
                _aten.full_like.default}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpCost(TorchDispatchMode):
    """Counts what the ops dispatched inside ``with OpCost() as cost:``
    cost; read ``flops``, ``bytes``, ``peak_bytes`` (the most bytes of
    storages created inside the window alive at once), ``live_bytes``,
    ``n_ops`` and ``by_op`` (the counts by op name) after the window."""

    def __init__(self, bucket_re: str | None = None) -> None:
        super().__init__()
        self.bucket = re.compile(bucket_re) if bucket_re else None
        self.flops = 0
        self.bytes = 0
        self.bucket_flops = 0
        self.bucket_bytes = 0
        self.n_ops = 0
        self.live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.by_op: dict = defaultdict(lambda: {"flops": 0, "bytes": 0,
                                                "calls": 0})
        self._regions: list[str] = []

    @contextlib.contextmanager
    def region(self, name: str):
        self._regions.append(name)
        try:
            yield self
        finally:
            self._regions.pop()

    # ---------------- storage lifetimes ----------------
    def _freed(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def _track(self, out, args) -> None:
        seen = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.live:
                continue
            seen.add(key)
            self.live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._freed, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # ---------------- dispatch ----------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        if not (func.is_view or func in _NO_TRAFFIC):
            nbytes = sum(tensor_bytes(t) for t in _tensors(out))
            if func not in _RESULT_ONLY:
                nbytes += sum(tensor_bytes(t)
                              for t in _tensors((args, kwargs)))
        self.n_ops += 1
        self.flops += flops
        self.bytes += nbytes
        name = str(packet)
        op = self.by_op[name]
        op["flops"] += flops
        op["bytes"] += nbytes
        op["calls"] += 1
        path = "/".join(self._regions)
        if self.bucket is not None and self.bucket.search(f"{path}:{name}"):
            self.bucket_flops += flops
            self.bucket_bytes += nbytes
        self._track(out, (args, kwargs))
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes, "live_bytes": self.live_bytes,
                "bucket_flops": self.bucket_flops,
                "bucket_bytes": self.bucket_bytes, "n_ops": self.n_ops}

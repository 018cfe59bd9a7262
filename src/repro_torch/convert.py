"""numpy trees <-> the port's tensor dicts, bit for bit.

The JAX package's params, caches and optimizer states, turned into numpy
arrays (``jax.tree.map(np.asarray, tree)``), become the port's nested dicts
of tensors with the same keys, shapes and dtypes, so both packages compute on
the same numbers.  ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``, so a
bf16 array crosses as its 16-bit pattern: viewed as int16 in numpy, then
viewed as ``torch.bfloat16`` in torch.  ``tree_to_numpy`` is the inverse.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A tensor that owns a copy of ``a``'s bytes (decode writes caches
    in place, so it must never share memory with the source)."""
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device):
    """Nested dicts of arrays -> the same of tensors; params and caches
    alike."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def opt_state_from_numpy(tree, device):
    """An optimizer state of the JAX package (``opt_init``'s tree, as
    numpy) -> the port's: the same keys, the fp32 moments and Adafactor's
    bf16 ``m`` bit for bit, and the int32 step ``count`` as a 0-d tensor."""
    state = params_from_numpy(tree, device)
    if state["count"].dtype != torch.int32 or state["count"].dim() != 0:
        raise ValueError("an optimizer state's count is a 0-d int32")
    return state



def tree_to_numpy(tree, bfloat16=None):
    """Nested dicts of tensors -> the same of numpy arrays, host copies in
    the JAX package's dtypes.  numpy has no bf16 of its own: pass
    ``ml_dtypes.bfloat16`` to get one; without it a bf16 tensor comes back
    as its int16 bit pattern."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v, bfloat16) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        a = t.view(torch.int16).numpy().copy()
        return a.view(bfloat16) if bfloat16 is not None else a
    return t.numpy().copy()

"""Stripe pack / unpack: the Hopper kernels' wrappers and their plain twins.

``shard_pack`` and ``shard_unpack`` are the counterparts of the JAX
package's ``shard_pack_pallas`` and ``shard_unpack_pallas``
(kernels/shard_pack.py) with their shapes: ``cells`` (n_cells, cell_rows,
128) -> ``packed`` (width, n_cells // width, cell_rows, 128), cell c to
target c % width, slot c // width, and back.  Words are carried as int32
bit patterns (torch's uint32 lacks most operations); the kernels only move
bytes.  On a CUDA tensor each launches its kernel in ``csrc/shard_pack.cu``
or raises; on a CPU tensor each computes its plain twin, which
``chip_smoke.py`` also uses as the on-card oracle.  ``PACK_LAUNCHES`` and
``UNPACK_LAUNCHES`` count kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

CELL_COLS = 128
# each library function's arguments before the stream (``build.kernel``)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64)

PACK_LAUNCHES = 0
UNPACK_LAUNCHES = 0


def shard_pack_reference(cells: torch.Tensor, width: int) -> torch.Tensor:
    n_cells = cells.shape[0]
    return cells.view(n_cells // width, width, *cells.shape[1:]) \
        .transpose(0, 1).contiguous()


def shard_unpack_reference(packed: torch.Tensor) -> torch.Tensor:
    width, cpt = packed.shape[:2]
    return packed.transpose(0, 1).contiguous() \
        .view(width * cpt, *packed.shape[2:])


def _check(t: torch.Tensor, dims: int, name: str) -> bool:
    """True for a CUDA tensor the kernel takes, False for a CPU tensor;
    raises for anything else."""
    if t.dim() != dims or t.shape[-1] != CELL_COLS or t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 with {dims} dims, the last "
                         f"{CELL_COLS}; got {t.dtype} {tuple(t.shape)}")
    if not build.on_card(t.device):
        return False
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("the kernel needs a contiguous, 16-byte aligned "
                         "tensor")
    return True


def shard_pack(cells: torch.Tensor, width: int) -> torch.Tensor:
    """cells: (n_cells, cell_rows, 128) int32, n_cells % width == 0
    (``ops.shard_pack`` pads) -> (width, n_cells // width, cell_rows, 128)."""
    on_card = _check(cells, 3, "cells")
    n_cells = cells.shape[0]
    if width < 1 or n_cells % width:
        raise ValueError(f"{n_cells} cells do not split over width {width}")
    if not on_card or n_cells == 0:
        return shard_pack_reference(cells, width)
    cpt = n_cells // width
    packed = torch.empty((width, cpt) + tuple(cells.shape[1:]),
                         dtype=cells.dtype, device=cells.device)
    build.launch(build.kernel("shard_pack", "shard_pack", _ARGTYPES),
                 cells.device, cells.data_ptr(), packed.data_ptr(), width,
                 cpt, cells.shape[1] * CELL_COLS * 4, what="shard_pack")
    global PACK_LAUNCHES
    PACK_LAUNCHES += 1
    return packed


def shard_unpack(packed: torch.Tensor) -> torch.Tensor:
    """The inverse: (width, cpt, cell_rows, 128) -> (width * cpt,
    cell_rows, 128)."""
    if not _check(packed, 4, "packed") or packed.numel() == 0:
        return shard_unpack_reference(packed)
    width, cpt = packed.shape[:2]
    cells = torch.empty((width * cpt,) + tuple(packed.shape[2:]),
                        dtype=packed.dtype, device=packed.device)
    build.launch(build.kernel("shard_pack", "shard_unpack", _ARGTYPES),
                 packed.device, packed.data_ptr(), cells.data_ptr(), width,
                 cpt, packed.shape[2] * CELL_COLS * 4, what="shard_unpack")
    global UNPACK_LAUNCHES
    UNPACK_LAUNCHES += 1
    return cells

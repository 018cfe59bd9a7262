"""Weighted uint32 checksum: the Hopper kernel's wrapper and its plain twin.

``checksum`` is the counterpart of the JAX package's
``checksum_words_pallas`` (kernels/checksum.py) together with the word view
its wrapper builds: ``sum_i W^(i+1) * w_i mod 2^32`` over the
little-endian uint32 words of a tensor's bytes (the last word
zero-padded), without the length mix, which ``ops.checksum_array`` adds on
the host.  On a CUDA tensor it launches the kernel in ``csrc/checksum.cu``
on the tensor's own bytes, with no copy, or raises; on a CPU tensor it
computes the plain twin ``checksum_reference``, which ``chip_smoke.py``
also uses as the on-card oracle.  ``CHECKSUM_LAUNCHES`` counts kernel
launches and nothing else.

Both return a 0-d int32 tensor holding the sum's 32-bit pattern on the
input's device; ``int(t) & 0xFFFFFFFF`` is the unsigned value.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

WEIGHT = 2654435761
MASK32 = 0xFFFFFFFF
# Words per chunk of the twin: its int64 temporaries stay a few times 32 MB
# however large the buffer.
CHUNK_WORDS = 1 << 22

CHECKSUM_LAUNCHES = 0


def byte_view(x: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor as a flat uint8 view (no copy)."""
    if not x.is_contiguous():
        raise ValueError("checksum takes a contiguous tensor; make the "
                         "copy explicitly")
    x = x.detach().reshape(-1)
    return x if x.dtype == torch.uint8 else x.view(torch.uint8)


def mul32(a, b):
    """``a * b mod 2^32`` for int64 tensors (or ints) holding uint32 values,
    split at 16 bits so that no int64 product overflows."""
    return ((a & 0xFFFF) * b + (((a >> 16) * (b & 0xFFFF)) << 16)) & MASK32


@functools.lru_cache(maxsize=8)
def _weights(n: int, device: str) -> torch.Tensor:
    """W^1 .. W^n mod 2^32 as int64, by doubling: n is a power of two."""
    w = torch.tensor([WEIGHT], dtype=torch.int64, device=device)
    while w.numel() < n:
        w = torch.cat([w, mul32(w, pow(WEIGHT, w.numel(), 1 << 32))])
    return w


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 in [0, 2^32) -> the int32 with the same bit pattern."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def checksum_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain torch in int64, a chunk of CHUNK_WORDS words at a time: chunk
    ``k`` adds ``W^(k*CHUNK_WORDS) * sum_j W^(j+1) w_(k*CHUNK_WORDS+j)``."""
    u8 = byte_view(x)
    n = u8.numel()
    acc = torch.zeros((), dtype=torch.int64, device=u8.device)
    if n == 0:
        return _as_int32(acc)
    if n % 4 or u8.storage_offset() % 4:
        u8 = torch.cat([u8, u8.new_zeros((-n) % 4)])
    words = u8.view(torch.int32)
    n_words = words.numel()
    n_w = min(CHUNK_WORDS, 1 << (n_words - 1).bit_length())
    weights = _weights(n_w, str(u8.device))
    for start in range(0, n_words, CHUNK_WORDS):
        w = words[start:start + CHUNK_WORDS].to(torch.int64) & MASK32
        part = mul32(w, weights[:w.numel()]).sum() & MASK32
        acc = (acc + mul32(part, pow(WEIGHT, start, 1 << 32))) & MASK32
    return _as_int32(acc)


def checksum(x: torch.Tensor) -> torch.Tensor:
    """The weighted sum of a contiguous tensor's bytes (no length mix).  On
    a CUDA tensor the kernel reads the tensor in place; its address must be
    4-byte aligned, and a tensor that is not is refused, not copied."""
    u8 = byte_view(x)
    dev = u8.device
    if dev.type == "cpu":
        return checksum_reference(u8)
    if dev.type != "cuda":
        raise ValueError(f"runs on cuda or cpu, not {dev}")
    if u8.numel() == 0:               # the empty sum; nothing to launch
        return torch.zeros((), dtype=torch.int32, device=dev)
    if u8.data_ptr() % 4:
        raise ValueError("the checksum kernel needs a 4-byte aligned tensor")
    out = torch.empty((), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(u8.data_ptr(), u8.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"checksum kernel launch failed: cudaError {err}")
    global CHECKSUM_LAUNCHES
    CHECKSUM_LAUNCHES += 1
    return out


def _kernel():
    fn = build.load("checksum").checksum_words
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p]
    return fn

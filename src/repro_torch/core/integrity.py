"""End-to-end data integrity — DAOS checksums, TPU-adapted.

DAOS computes a checksum client-side on update, stores it with the extent, and
verifies on fetch (end-to-end: detects corruption anywhere on the path).  We
use a positional weighted checksum over uint32 words:

    csum(x) = ( sum_i  W^(i+1) * x_i  mod 2^32 )  xor  mix(len)

with W = 2654435761 (Knuth's multiplicative constant).  Positional weights make
it order-sensitive (unlike a plain sum) and the form is *tile-decomposable*:

    csum = sum_t  W^(t*T) * csum_tile(x_t)

which is exactly what the Pallas kernel in ``repro.kernels.checksum`` exploits
to compute it on-device with (8,128) VMEM tiles.  This module is the host-side
numpy implementation; ``tests/test_kernels.py`` asserts all three (numpy,
ref.py jnp oracle, Pallas interpret) agree bit-for-bit.
"""
from __future__ import annotations

import numpy as np

WEIGHT = np.uint32(2654435761)
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4B5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _as_u32_words(data) -> tuple[np.ndarray, int]:
    """View arbitrary bytes as little-endian uint32 words (zero padded)."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    else:
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = buf.size
    pad = (-n) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    return buf.view("<u4"), n


def weight_powers(n: int, start_power: int = 1) -> np.ndarray:
    """W^(start_power), W^(start_power+1), ..., length n, as uint32."""
    if n == 0:
        return np.zeros(0, np.uint32)
    out = np.empty(n, np.uint32)
    w = pow(int(WEIGHT), start_power, 1 << 32)
    out[0] = w
    if n > 1:
        # cumulative product with natural uint32 wraparound
        np.multiply.accumulate(
            np.concatenate([[np.uint32(w)], np.full(n - 1, WEIGHT)]),
            out=out, dtype=np.uint32)
    return out


def checksum(data) -> int:
    """Weighted-word checksum of a bytes-like / ndarray. Returns python int."""
    words, nbytes = _as_u32_words(data)
    with np.errstate(over="ignore"):
        acc = np.uint32(0)
        if words.size:
            w = weight_powers(words.size)
            acc = np.sum(w * words, dtype=np.uint32)
    return int(acc) ^ (_splitmix64(nbytes) & 0xFFFFFFFF)


class ChecksumError(IOError):
    """End-to-end integrity violation: stored checksum != recomputed."""

    def __init__(self, where: str, expected: int, got: int):
        super().__init__(
            f"checksum mismatch at {where}: stored={expected:#010x} "
            f"computed={got:#010x}")
        self.where, self.expected, self.got = where, expected, got


def verify(data, expected: int, where: str = "?") -> None:
    got = checksum(data)
    if got != expected:
        raise ChecksumError(where, expected, got)

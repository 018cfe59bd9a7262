"""The port's checksum held against the JAX package, bit for bit, on the CPU
where the port's wrapper takes its plain twin: the twin and
``ops.checksum_array`` against ``checksum_words_pallas`` in interpret mode
(through the JAX ``ops.checksum_array``), its jnp oracle and
``core.integrity.checksum``, over the reference tests' sizes, odd byte
counts, the checkpoint leaves' dtypes and unaligned views."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import integrity
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.checksum import TILE, checksum_words_pallas
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import integrity as port_integrity
from repro_torch.kernels import checksum as ck
from repro_torch.kernels import ops


def _bytes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


# the sizes of tests/test_kernels.py, plus every residue mod 4 and mod 16
@pytest.mark.parametrize("nbytes", [0, 1, 2, 3, 4, 5, 6, 7, 15, 16, 17, 64,
                                    1023, 4096, 4097, 65536, 100_001])
def test_checksum_array_matches_jax_and_host(nbytes):
    data = _bytes(nbytes, nbytes)
    got = ops.checksum_array(torch.from_numpy(data))
    assert got == jops.checksum_array(data)
    assert got == integrity.checksum(data.tobytes())


@pytest.mark.parametrize("words", [1, 5, TILE, 4 * TILE + 3])
def test_twin_matches_pallas_kernel_and_jnp_oracle(words):
    """The twin's weighted sum (no length mix) against the TPU kernel run
    in interpret mode on the same words, and against ref.py's oracle."""
    w = np.random.default_rng(words).integers(0, 2**32, words,
                                              dtype=np.uint32)
    n_tiles = -(-words // TILE)
    padded = np.zeros(n_tiles * TILE, np.uint32)
    padded[:words] = w
    pallas = checksum_words_pallas(
        jnp.asarray(padded.reshape(n_tiles * 8, 128)),
        jnp.asarray(jops._tile_scales(n_tiles)),
        jnp.asarray(jops._weights_tile()))[0, 0]
    twin = ck.checksum_reference(torch.from_numpy(w.view(np.int32)))
    assert twin.dtype == torch.int32 and twin.dim() == 0
    assert int(twin) & ck.MASK32 == int(pallas) == \
        int(ref.checksum_words(jnp.asarray(w)))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32", "float16",
                                   "int32", "float64"])
def test_checkpoint_leaf_dtypes(dtype):
    rng = np.random.default_rng(7)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    if dtype.startswith("int"):
        a = rng.integers(-100, 100, (17, 33)).astype(np_dtype)
    else:
        a = rng.normal(size=(17, 33)).astype(np_dtype)
    t = tensor_from_numpy(a, "cpu")
    assert ops.checksum_array(t) == jops.checksum_array(a) \
        == integrity.checksum(a)


def test_zero_dim_int32_leaf():
    """An optimizer state's step count: a 0-d int32, 4 bytes."""
    a = np.asarray(7, np.int32)
    t = torch.tensor(7, dtype=torch.int32)
    assert ops.checksum_array(t) == jops.checksum_array(a) \
        == integrity.checksum(a)


@pytest.mark.parametrize("offset", [1, 2, 3, 4, 5, 12])
def test_unaligned_views(offset):
    data = _bytes(offset, 4099)
    view = torch.from_numpy(data)[offset:]
    assert view.storage_offset() == offset
    assert ops.checksum_array(view) == integrity.checksum(data[offset:])


@pytest.mark.parametrize("nbytes", [4 * 1024 - 1, 4 * 1024, 4 * 1024 + 1,
                                    3 * 4 * 1024 + 2, 40_003])
def test_twin_chunks_join_exactly(monkeypatch, nbytes):
    """Chunk boundaries: the twin scales each chunk by W^(k * chunk)."""
    monkeypatch.setattr(ck, "CHUNK_WORDS", 1024)
    data = _bytes(nbytes + 1, nbytes)
    assert ops.checksum_array(torch.from_numpy(data)) == \
        integrity.checksum(data)


def test_order_sensitive_and_bit_flip():
    a = torch.arange(4096, dtype=torch.int32).to(torch.uint8)
    assert ops.checksum_array(a) != ops.checksum_array(a.flip(0))
    b = torch.from_numpy(_bytes(3, 8192))
    c = b.clone()
    c[1234] ^= 1
    assert ops.checksum_array(b) != ops.checksum_array(c)


def test_mul32_matches_python_modular_product():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.int64)
    b = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.int64)
    got = ck.mul32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = [(int(x) * int(y)) % (1 << 32) for x, y in zip(a, b)]
    np.testing.assert_array_equal(got, np.asarray(want, np.int64))


def test_cpu_tensor_takes_the_twin_and_counts_no_launch():
    before = ck.CHECKSUM_LAUNCHES
    x = torch.from_numpy(_bytes(9, 1000))
    assert torch.equal(ck.checksum(x), ck.checksum_reference(x))
    assert ck.CHECKSUM_LAUNCHES == before


def test_non_contiguous_tensor_is_refused_not_copied():
    x = torch.zeros((8, 8), dtype=torch.float32).t()
    with pytest.raises(ValueError, match="contiguous"):
        ck.checksum(x)


def test_port_integrity_is_the_reference_function():
    """The port's copy of core.integrity computes the same checksum."""
    data = _bytes(11, 12345)
    assert port_integrity.checksum(data) == integrity.checksum(data)

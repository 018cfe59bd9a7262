"""The port's stripe pack / unpack held against the JAX package, bit for
bit, on the CPU where the port's wrappers take their plain twins: the
twins against ``shard_pack_pallas`` / ``shard_unpack_pallas`` in interpret
mode at the reference tests' widths and cell sizes, and ``ops.shard_pack``
/ ``ops.shard_unpack`` against the JAX wrappers, padding and meta
included."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.shard_pack import shard_pack_pallas, shard_unpack_pallas
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import shard_pack as sp


def _bits(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("width", [1, 2, 4, 16])
@pytest.mark.parametrize("n_cells_mult", [1, 3])
@pytest.mark.parametrize("cell_rows", [1, 2])
def test_twins_match_pallas_kernels(width, n_cells_mult, cell_rows):
    n_cells = width * n_cells_mult
    words = np.random.default_rng(width * 10 + n_cells_mult).integers(
        0, 2**32, (n_cells, cell_rows, 128), dtype=np.uint32)
    want = np.asarray(shard_pack_pallas(jnp.asarray(words), width))
    cells = torch.from_numpy(words.view(np.int32))
    before = (sp.PACK_LAUNCHES, sp.UNPACK_LAUNCHES)
    packed = sp.shard_pack(cells, width)
    assert packed.shape == want.shape
    np.testing.assert_array_equal(_bits(packed), want)
    back = sp.shard_unpack(packed)
    np.testing.assert_array_equal(
        _bits(back), np.asarray(shard_unpack_pallas(jnp.asarray(want))))
    np.testing.assert_array_equal(_bits(back), words)
    assert (sp.PACK_LAUNCHES, sp.UNPACK_LAUNCHES) == before   # CPU: twins


@pytest.mark.parametrize("nbytes,width,cell", [(123457, 4, 2048),
                                               (512, 1, 512),
                                               (1 << 20, 16, 65536),
                                               (100_003, 3, 4096)])
def test_ops_match_jax_wrappers_and_round_trip(nbytes, width, cell):
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                  dtype=np.uint8)
    packed, meta = ops.shard_pack(torch.from_numpy(data), width,
                                  cell_bytes=cell)
    jpacked, jmeta = jops.shard_pack(data, width=width, cell_bytes=cell)
    assert meta == jmeta
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(_bits(packed), np.asarray(jpacked))
    back = ops.shard_unpack(packed, meta)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), data)
    np.testing.assert_array_equal(back.numpy(),
                                  jops.shard_unpack(jpacked, jmeta))


def test_bf16_leaf_packs_as_its_bytes():
    a = np.random.default_rng(2).normal(size=(64, 96)) \
        .astype(ml_dtypes.bfloat16)
    packed, meta = ops.shard_pack(tensor_from_numpy(a, "cpu"), 4,
                                  cell_bytes=2048)
    jpacked, jmeta = jops.shard_pack(a, width=4, cell_bytes=2048)
    assert meta == jmeta
    np.testing.assert_array_equal(_bits(packed), np.asarray(jpacked))
    np.testing.assert_array_equal(ops.shard_unpack(packed, meta).numpy(),
                                  a.view(np.uint8).reshape(-1))


def test_bad_shapes_are_refused():
    with pytest.raises(ValueError, match="multiple of 512"):
        ops.shard_pack(torch.zeros(100, dtype=torch.uint8), 2,
                       cell_bytes=1000)
    with pytest.raises(ValueError, match="do not split"):
        sp.shard_pack(torch.zeros((5, 1, 128), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="int32"):
        sp.shard_pack(torch.zeros((4, 1, 128), dtype=torch.float32), 2)

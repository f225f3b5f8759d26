"""The port's stochastic-rounding helpers (aread_tpu_torch/ops/rounding.py)
against the JAX package's on the same seed-made inputs: integer math, so
bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.ops import rounding as jr
from aread_tpu.ops.sparse_adam import _row_flat_index as j_row_flat_index
from aread_tpu_torch.ops import rounding as tr
from aread_tpu_torch.ops.sparse_adam import _row_flat_index


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 5, 2**31 - 1])
def test_hash_bits_bitwise(seed):
    rng = np.random.default_rng(seed % 97)
    idx = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jr.hash_bits(jnp.asarray(idx), jnp.int32(seed)))
    got = tr.hash_bits(torch.as_tensor(idx.astype(np.int64)), seed)
    np.testing.assert_array_equal(_u32(got), want)


def test_stochastic_round_bf16_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=2048) * 10.0 ** rng.integers(-8, 8, 2048),
                        [0.0, -0.0, 1.0, -2.0, 3.4e38, -3.4e38]]).astype(np.float32)
    rbits = rng.integers(0, 2**32, size=x.size, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jr.stochastic_round_bf16(jnp.asarray(x), jnp.asarray(rbits)))
    got = tr.stochastic_round_bf16(torch.as_tensor(x),
                                   torch.as_tensor(rbits.astype(np.int64)))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sround_bitwise(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 128)).astype(np.float32)
    idx = np.arange(16 * 128, dtype=np.uint32).reshape(16, 128)
    want = np.asarray(jr.sround(jnp.asarray(x), jnp.dtype(dtype),
                                jnp.asarray(idx), jnp.int32(9)).astype(jnp.float32))
    got = tr.sround(torch.as_tensor(x), getattr(torch, dtype),
                    torch.as_tensor(idx.astype(np.int64)), 9)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("n_rows,d", [(64, 32), (32, 8), (48, 16), (10, 3)])
def test_flat_index_grid_bitwise(n_rows, d):
    want = np.asarray(jr.flat_index_grid(n_rows, d))
    got = tr.flat_index_grid(n_rows, d)
    np.testing.assert_array_equal(_u32(got), want)
    if 128 % d == 0:  # the lane-packed order is the row-major order
        np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                      np.arange(n_rows * d))


@pytest.mark.parametrize("d", [8, 32, 3])
def test_row_flat_index_bitwise(d):
    rows = np.random.default_rng(d).integers(0, 5000, size=300).astype(np.int32)
    want = np.asarray(j_row_flat_index(jnp.asarray(rows), d))
    got = _row_flat_index(torch.as_tensor(rows), d)
    np.testing.assert_array_equal(_u32(got), want)

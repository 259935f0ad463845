"""PyTorch port, the materialization barrier (kernel 7): on the CPU the
wrapper runs its plain version, an identity copy into a new tensor, bit for
bit, for any dtype, length and layout; the JAX ``materialize`` (an identity
off the TPU) agrees on the same numpy input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.kernels.pallas.barrier import materialize as jmaterialize
from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.kernels.barrier import materialize, materialize_plain

# lengths around the TPU kernel's (256, 128) = 32768-element tile, and 8195
# 4-byte elements: 12 bytes past the card kernel's 32 KB bulk-copy stage
LENGTHS = [1, 7, 127, 8195, 32767, 32769, 100003]


def _data(dtype, n, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-(1 << 31), 1 << 31, size=n, dtype=np.int64).astype(np.int32)
    return rng.normal(size=n).astype(dtype)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n", LENGTHS)
def test_identity_bit_for_bit(dtype, n):
    x = _data(dtype, n, seed=n)
    t = torch.from_numpy(x)
    got = materialize(t)
    assert got.dtype == t.dtype and got.shape == t.shape
    assert got.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(x))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(jmaterialize(jnp.asarray(x)))))


@pytest.mark.parametrize("view", ["step", "transpose", "offset"])
def test_strided_input(view):
    base = torch.from_numpy(_data(np.float32, 6 * 4099, seed=3)).reshape(6, 4099)
    x = {"step": base[:, ::3], "transpose": base.T, "offset": base.reshape(-1)[1:]}[view]
    got = materialize(x)
    assert got.shape == x.shape
    assert torch.equal(got, x)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(x.numpy()))


@pytest.mark.parametrize("shape", [(0,), (3, 0), (0, 5, 2)])
def test_empty(shape):
    x = torch.zeros(shape, dtype=torch.float32)
    got = materialize(x)
    assert got.shape == x.shape and got.dtype == x.dtype and got.numel() == 0
    assert np.asarray(jmaterialize(jnp.zeros(shape, jnp.float32))).shape == shape


def test_the_copy_does_not_alias():
    x = torch.arange(10, dtype=torch.float32)
    y = materialize(x)
    y[0] = 42.0
    assert float(x[0]) == 0.0
    assert torch.equal(materialize_plain(x), x)


def test_other_dtypes_and_shapes():
    for x in (torch.tensor([True, False, True]),
              torch.arange(24, dtype=torch.int8).reshape(2, 3, 4),
              torch.randn(5, 3, dtype=torch.float64),
              torch.randn(9, dtype=torch.complex64)):
        got = materialize(x)
        assert got.dtype == x.dtype and torch.equal(got, x)


def test_cpu_runs_no_kernel():
    _build.reset_launches()
    materialize(torch.ones(1000))
    assert _build.launches["materialize"] == 0


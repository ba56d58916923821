"""The port's row shifts (pvnet_tpu_torch/ops/row_shift.py) against the JAX
package's shift_lanes / shift_sublanes, on the CPU.

JAX runs both ways its own tests run it: the Pallas kernel in interpret
mode (interpret=True) and the XLA fallback (interpret=None on the CPU).
The port on a CPU tensor runs its plain version. Elements are moved, never
computed on, so the results must be equal exactly, over the shapes and
dtypes of tests/test_row_shift.py with negative and over-range starts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.ops.row_shift import shift_lanes as j_lanes
from pvnet_tpu.ops.row_shift import shift_sublanes as j_sublanes
from pvnet_tpu_torch.ops import row_shift as RS

_MODES = [None, True]
_DTYPES = [np.float32, np.int32, np.uint8]


def _data(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == np.float32:
        return rng.rand(*shape).astype(np.float32)
    return rng.randint(0, 200, shape).astype(dtype)


@pytest.mark.parametrize("interpret", _MODES)
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", [(3, 37, 100), (2, 16, 640), (1, 5, 129)])
def test_shift_lanes_equals_jax(shape, dtype, interpret):
    P, R, C = shape
    x = _data(shape, dtype, C)
    s = np.random.RandomState(R).randint(-C, 3 * C, (P, R)).astype(np.int32)
    want = np.asarray(j_lanes(jnp.asarray(x), jnp.asarray(s),
                              interpret=interpret))
    got = RS.shift_lanes(torch.from_numpy(x), torch.from_numpy(s))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("interpret", _MODES)
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", [(5, 53, 41), (2, 480, 130), (8, 7, 128)])
def test_shift_sublanes_equals_jax(shape, dtype, interpret):
    P, H, C = shape
    x = _data(shape, dtype, H)
    s = np.random.RandomState(C).randint(-H, 2 * H, (P, C)).astype(np.int32)
    want = np.asarray(j_sublanes(jnp.asarray(x), jnp.asarray(s),
                                 interpret=interpret))
    got = RS.shift_sublanes(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_starts_and_zero_shift():
    # int64 starts beyond int32 range reduce exactly; zero is the identity
    x = torch.arange(2 * 3 * 10, dtype=torch.float32).reshape(2, 3, 10)
    big = torch.full((2, 3), 10 * 2**40 + 3, dtype=torch.int64)
    np.testing.assert_array_equal(
        RS.shift_lanes(x, big).numpy(),
        RS.shift_lanes(x, torch.full((2, 3), 3)).numpy())
    assert torch.equal(RS.shift_lanes(x, torch.zeros(2, 3, dtype=torch.int32)),
                       x)
    assert torch.equal(RS.shift_sublanes(x, torch.zeros(2, 10,
                                                        dtype=torch.int8)), x)


def test_cpu_takes_the_plain_version_without_counting():
    x = torch.rand(2, 4, 16)
    s = torch.randint(-20, 20, (2, 4))
    before = (RS.shift_lanes.launches, RS.shift_sublanes.launches)
    assert torch.equal(RS.shift_lanes(x, s), RS.shift_lanes_plain(x, s))
    s2 = torch.randint(-20, 20, (2, 16))
    assert torch.equal(RS.shift_sublanes(x, s2),
                       RS.shift_sublanes_plain(x, s2))
    assert (RS.shift_lanes.launches, RS.shift_sublanes.launches) == before


def test_rejects_bad_arguments():
    x = torch.rand(2, 4, 16)
    with pytest.raises(ValueError, match="starts"):
        RS.shift_lanes(x, torch.zeros(2, 5, dtype=torch.int32))
    with pytest.raises(ValueError, match="starts"):
        RS.shift_sublanes(x, torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(TypeError, match="integer"):
        RS.shift_lanes(x, torch.zeros(2, 4))
    with pytest.raises(ValueError):
        RS.shift_lanes(x[0], torch.zeros(4, dtype=torch.int32))

"""The port's plain word-space tier (ops/torch_ops.py) against the JAX
package's xla_ops and the numpy oracle on the same inputs. Counting is
integer-exact, so every comparison is exact (tolerance 0), as int64:
JAX sums are int32 and the port's are int64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import xla_ops as X
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.ops import torch_ops as T

from conftest import pospopcnt_ref

EDGE_SIZES = [0, 1, 255, 256, 511, 512, 1023, 1024, 70_001]


def _i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_stream_sums_equal_xla(n, full_range):
    x = generate_flags(n, seed=n + 11, full_range=full_range)
    jt, jf = X.stream_sums_xla(jnp.asarray(x))
    tt, tf = T.stream_sums_torch(torch.from_numpy(x))
    np.testing.assert_array_equal(tt.numpy(), _i64(jt))
    np.testing.assert_array_equal(tf.numpy(), _i64(jf))


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_flagstat_equal_xla_and_oracle(n, full_range):
    x = generate_flags(n, seed=n + 12, full_range=full_range)
    got = T.flagstat_torch(x).numpy()
    np.testing.assert_array_equal(got, _i64(X.flagstat_xla(jnp.asarray(x))))
    np.testing.assert_array_equal(got, _i64(flagstat_numpy(x)))


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_pospopcnt_equal_xla(n, full_range):
    x = generate_flags(n, seed=n + 13, full_range=full_range)
    got = T.pospopcnt_u16_torch(x).numpy()
    np.testing.assert_array_equal(got, _i64(X.pospopcnt_u16_xla(jnp.asarray(x))))
    np.testing.assert_array_equal(got, pospopcnt_ref(x))


@pytest.mark.parametrize("value", [0xFFFF, 0x0FFF, 0x8000, 0x0200])
def test_saturated_words(value):
    x = np.full(1000, value, dtype=np.uint16)
    np.testing.assert_array_equal(T.flagstat_torch(x).numpy(), _i64(flagstat_numpy(x)))
    np.testing.assert_array_equal(T.pospopcnt_u16_torch(x).numpy(), pospopcnt_ref(x))


@pytest.mark.parametrize("n", [1, 4099, 70_001])
def test_assemble_counters_cross_fed(n, full_range):
    """The stratified sums cross between the packages: JAX's sums through
    the port's assemble_counters, the port's through JAX's."""
    x = generate_flags(n, seed=n + 14, full_range=full_range)
    jt, jf = X.stream_sums_xla(jnp.asarray(x))
    want = _i64(X.assemble_counters(jt, jf, n))
    np.testing.assert_array_equal(want, _i64(flagstat_numpy(x)))

    total, fail = T.stream_sums_from_numpy(np.asarray(jt), np.asarray(jf))
    assert total.dtype == fail.dtype == torch.int64
    np.testing.assert_array_equal(T.assemble_counters(total, fail, n).numpy(), want)

    tt, tf = T.stream_sums_torch(x)
    back = X.assemble_counters(jnp.asarray(tt.numpy()), jnp.asarray(tf.numpy()), n)
    np.testing.assert_array_equal(_i64(back), want)


def test_assemble_counters_uses_true_length():
    """Counter 9 is the derived pass total: padding must never reach it."""
    x = generate_flags(300, seed=5, full_range=True)
    padded = np.concatenate([x, np.zeros(700, np.uint16)])
    total, fail = T.stream_sums_torch(padded)
    got = T.assemble_counters(total, fail, x.size).numpy()
    np.testing.assert_array_equal(got, _i64(flagstat_numpy(x)))


def test_stream_sums_from_numpy_rejects_wrong_shape():
    with pytest.raises(ValueError, match="shape"):
        T.stream_sums_from_numpy(np.zeros(32, np.int32), np.zeros(16, np.int32))


def test_as_words_rejects_other_dtypes():
    with pytest.raises(ValueError, match="uint16"):
        T.as_words(np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="uint16"):
        T.as_words(torch.zeros(4, dtype=torch.int32))

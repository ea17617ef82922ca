"""The port's host bit transpose (ops/bitslice.pretranspose_host*, built
through the port's own loader of the native library) is byte-identical
to the JAX package's, at group-edge sizes, with and without an ``out``
buffer; a bad packed row list fails in both."""
import numpy as np
import pytest

from libflagstats_tpu.ops import bitslice as jB
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import generate_flags
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.ops import bitslice as tB
from libflagstats_tpu_torch.ops import kernels as K

SIZES = [1, 65_535, 65_536, 65_537, 8 * 65_536 - 4_321]


@pytest.fixture(scope="module", autouse=True)
def native():
    assert native_lib.load() is not None, native_lib.BUILD_ERROR


@pytest.mark.parametrize("n", SIZES)
def test_pretranspose_equals_jax(n):
    x = generate_flags(n, seed=n, full_range=True)
    np.testing.assert_array_equal(tB.pretranspose_host_np(x), jB.pretranspose_host_np(x))
    full = jB.pretranspose_host(x)
    got = tB.pretranspose_host(x, threads=2)
    assert got.dtype == np.uint32 and got.shape == full.shape == (-(-n // 65536), 32, 8, 128)
    np.testing.assert_array_equal(got, full)
    for report in (False, True):
        rows = PK.packed_rows_for(report)
        want = jB.pretranspose_host_packed(x, rows)
        np.testing.assert_array_equal(want, full[:, list(rows)])
        np.testing.assert_array_equal(tB.pretranspose_host_packed(x, K.packed_rows_for(report)),
                                      want)
        out = np.full(want.shape, 0xDEADBEEF, dtype=np.uint32)
        assert tB.pretranspose_host_packed(x, rows, 1, out=out) is out
        np.testing.assert_array_equal(out, want)


def test_numpy_fallback_equals_native(monkeypatch):
    """Without the native library the port transposes in numpy, to the
    same bytes (the numpy version defines the layout)."""
    x = generate_flags(2 * 65_536 - 7, seed=5, full_range=True)
    native_full = tB.pretranspose_host(x)
    native_packed = tB.pretranspose_host_packed(x, K.PACKED_ROWS_REPORT)
    monkeypatch.setattr(native_lib, "load", lambda: None)
    np.testing.assert_array_equal(tB.pretranspose_host(x), native_full)
    np.testing.assert_array_equal(tB.pretranspose_host_packed(x, K.PACKED_ROWS_REPORT),
                                  native_packed)


@pytest.mark.parametrize("rows", [(3, 3), (40,), ()], ids=["duplicate", "out-of-range", "empty"])
def test_bad_row_list_fails_in_both(rows):
    x = np.zeros(65_536, dtype=np.uint16)
    with pytest.raises((RuntimeError, IndexError, ValueError)):
        jB.pretranspose_host_packed(x, rows)
    with pytest.raises(ValueError, match="row list"):
        tB.pretranspose_host_packed(x, rows)


def test_bad_out_buffer_raises():
    x = np.zeros(65_536, dtype=np.uint16)
    for out in (np.empty((1, 24, 8, 128), np.int64),           # dtype
                np.empty((2, 24, 8, 128), np.uint32),          # shape
                np.empty((1, 24, 8, 256), np.uint32)[..., ::2]):  # strided
        with pytest.raises(ValueError, match="out must be"):
            tB.pretranspose_host_packed(x, K.PACKED_ROWS_FULL, out=out)

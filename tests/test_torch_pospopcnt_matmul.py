"""The port's "torch_matmul" pospopcnt tier (ops/torch_ops.pospopcnt_u16_matmul,
an int8 bit expansion reduced by a ones-matrix product through
torch._int_mm) against the JAX package's MXU tier
(xla_ops.pospopcnt_u16_matmul under jax.jit, and
pospopcnt_u16(impl="xla_matmul")) on the CPU, on the same words made
from a seed. The CPU runs the layout the card runs: the shapes handed to
torch._int_mm are checked against what it accepts on CUDA. Exact
(tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libflagstats_tpu as J
from libflagstats_tpu.ops.xla_ops import pospopcnt_u16_matmul as jax_matmul
from libflagstats_tpu.oracle import generate_flags

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import torch_ops as T

SIZES = [0, 1, 100, 127, 128, 4096, (1 << 17) - 1, (1 << 17) + 13, 1 << 18]


def _jax(x, **kw):
    return np.asarray(jax.jit(lambda a: jax_matmul(a, **kw))(jnp.asarray(x))).astype(np.int64)


@pytest.mark.parametrize("chunk", [128, 1 << 17])
@pytest.mark.parametrize("n", SIZES)
def test_matmul_equals_jax_matmul(n, chunk, full_range):
    x = generate_flags(n, seed=n % 89 + 5, full_range=full_range)
    got = T.pospopcnt_u16_matmul(x, chunk=chunk)
    assert got.dtype == torch.int64 and got.shape == (16,)
    np.testing.assert_array_equal(got.numpy(), _jax(x, chunk=chunk))


@pytest.mark.parametrize("n", [256, 300, (1 << 17) + 5])
def test_all_ones_words_do_not_wrap(n):
    """0xFFFF words: every int8 product term is 1, so a chunk's column
    sums reach far past 127 (an int8 accumulator would wrap)."""
    x = np.full(n, 0xFFFF, np.uint16)
    for chunk in (128, 1 << 17, D.MATMUL_CHUNK):
        got = T.pospopcnt_u16_matmul(x, chunk=chunk).numpy()
        np.testing.assert_array_equal(got, np.full(16, n))
        np.testing.assert_array_equal(got, _jax(x, chunk=chunk))
    np.testing.assert_array_equal(L.pospopcnt_u16(x, impl="torch_matmul", device="cpu"),
                                  J.pospopcnt_u16(x, impl="xla_matmul"))


@pytest.mark.parametrize("n_bits", [1, 5, 12, 16])
def test_n_bits_equals_jax(n_bits):
    x = generate_flags(5000, seed=n_bits, full_range=True)
    np.testing.assert_array_equal(T.pospopcnt_u16_matmul(x, n_bits=n_bits).numpy(),
                                  _jax(x, n_bits=n_bits))


@pytest.mark.parametrize("n", [0, 1, 1000, 70_001, 300_007])
def test_dispatch_equals_jax(n, full_range):
    x = generate_flags(n, seed=n % 83 + 7, full_range=full_range)
    want = J.pospopcnt_u16(x, impl="xla_matmul")
    np.testing.assert_array_equal(want, J.pospopcnt_u16(x, impl="numpy"))
    got = L.pospopcnt_u16(x, impl="torch_matmul", device="cpu")
    assert got.dtype == np.uint64 and got.shape == (16,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        L.pospopcnt_u16(torch.from_numpy(x), impl="torch_matmul", device="cpu"), want)


def test_dispatch_chunks_past_the_device_cap(monkeypatch):
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 1000)
    x = generate_flags(4321, seed=71, full_range=True)
    np.testing.assert_array_equal(L.pospopcnt_u16(x, impl="torch_matmul", device="cpu"),
                                  J.pospopcnt_u16(x, impl="xla_matmul"))


@pytest.mark.parametrize("n,chunk", [(1, 1 << 17), (5000, 200), (300_007, D.MATMUL_CHUNK)])
def test_int_mm_gets_the_card_layout(monkeypatch, n, chunk):
    """Every product is int8 x int8 -> int32 with the shapes torch._int_mm
    accepts on CUDA: more than 16 rows, k and n multiples of 8."""
    shapes = []
    int_mm = torch._int_mm

    def spy(a, b):
        shapes.append((a.dtype, tuple(a.shape), b.dtype, tuple(b.shape)))
        out = int_mm(a, b)
        assert out.dtype == torch.int32
        return out

    monkeypatch.setattr(torch, "_int_mm", spy)
    x = generate_flags(n, seed=3, full_range=True)
    np.testing.assert_array_equal(T.pospopcnt_u16_matmul(x, chunk=chunk).numpy(),
                                  _jax(x, chunk=chunk))
    assert shapes
    for a_dtype, (m, k), b_dtype, (k2, cols) in shapes:
        assert a_dtype == b_dtype == torch.int8
        assert m > 16 and k == k2 and k % 8 == 0 and cols % 8 == 0, shapes


def test_n_bits_out_of_range_raises():
    with pytest.raises(ValueError, match="n_bits"):
        T.pospopcnt_u16_matmul(np.zeros(4, np.uint16), n_bits=17)


def test_registered_but_never_chosen_by_size():
    assert "torch_matmul" in D.POSPOPCNT_IMPLS and "torch_matmul" not in D.FLAGSTAT_IMPLS
    for n in (0, 1, 1 << 16, 1 << 30):
        assert D.pospopcnt_auto_impl(n, device="cpu") != "torch_matmul"
        assert D.pospopcnt_auto_impl(n, device="cuda") == "cuda"
    with pytest.raises(ValueError, match="unknown impl"):
        L.flagstats_u16(np.zeros(4, np.uint16), impl="torch_matmul")


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "cpu-tensor"])
def test_counts_on_the_card_or_raises(as_tensor):
    """With no device asked for, the tier counts on the card, never on
    the CPU the words lie on: with no card it raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    x = generate_flags(1000, seed=9, full_range=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.pospopcnt_u16(torch.from_numpy(x) if as_tensor else x, impl="torch_matmul")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.pospopcnt_u16(x, impl="torch_matmul", device="cuda")

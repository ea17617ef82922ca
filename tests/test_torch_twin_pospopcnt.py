"""The port's plain kernel twin in mode "pospopcnt" (16 raw bit streams,
full unpruned transpose) against the JAX kernel body's jnp twin at one
shape of 8 x GROUP_WORDS, and the pospopcnt stages against their JAX
counterparts. Exact (tolerance 0), compared as int64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import bitslice as jB
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import generate_flags
from libflagstats_tpu_torch.ops import kernels as K

from conftest import pospopcnt_ref

MODE = "pospopcnt"
N = 8 * PK.GROUP_WORDS   # one Harley-Seal body: one jit compile for every case
CASES = {
    "flags<4096": lambda: generate_flags(N, seed=51),
    "full16bit": lambda: generate_flags(N, seed=52, full_range=True),
    "all-0xFFFF": lambda: np.full(N, 0xFFFF, np.uint16),
    "high-bits-only": lambda: np.full(N, 0xF000, np.uint16),
    "tail": lambda: generate_flags(N - 4097, seed=53, full_range=True),
}


def jnp_twin(x):
    """The JAX kernel body's jnp twin, run eagerly: the same ops as under
    jax.jit, without jit's 35-60 s compile of the unrolled body here."""
    sums = PK._stream_sums_jnp_body(PK._pack_stream(jnp.asarray(x), 8), MODE)
    return np.asarray(sums).astype(np.int64)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_jnp_twin(case):
    x = CASES[case]()
    sums = K.stream_sums_plain(torch.from_numpy(x), MODE).numpy()
    np.testing.assert_array_equal(sums, jnp_twin(x))
    np.testing.assert_array_equal(sums, pospopcnt_ref(x))


def test_full_transpose_and_streams_equal_jax():
    rng = np.random.default_rng(54)
    regs = [rng.integers(0, 1 << 32, size=(8, 128), dtype=np.uint32) for _ in range(32)]
    st = {j: jB.swap_pairs(j) for j, _ in jB.TRANSPOSE_STAGES}
    want = PK._stream_inputs_pospopcnt(PK._transpose32([jnp.asarray(r) for r in regs], st))
    got = K._stream_inputs_pospopcnt(
        K._transpose32([torch.from_numpy(r.view(np.int32)) for r in regs], st))
    assert len(got) == len(want) == 16
    for (w0, w1), (g0, g1) in zip(want, got):
        np.testing.assert_array_equal(g0.numpy().view(np.uint32), np.asarray(w0))
        np.testing.assert_array_equal(g1.numpy().view(np.uint32), np.asarray(w1))

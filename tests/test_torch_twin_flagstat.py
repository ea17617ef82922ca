"""The port's plain kernel twin (ops/kernels.stream_sums_plain) in mode
"flagstat" against the JAX kernel body's jnp twin
(pallas_kernels._stream_sums_jnp_body) at one shape of 8 x GROUP_WORDS,
and each stage against its JAX counterpart on small tiles. Exact
(tolerance 0), compared as int64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import bitslice as jB
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops.torch_ops import assemble_counters

MODE = "flagstat"
N = 8 * PK.GROUP_WORDS   # one Harley-Seal body: one jit compile for every case
CASES = {
    "flags<4096": lambda: generate_flags(N, seed=21),
    "full16bit": lambda: generate_flags(N, seed=22, full_range=True),
    "all-0xFFFF": lambda: np.full(N, 0xFFFF, np.uint16),
    "all-0x0FFF": lambda: np.full(N, 0x0FFF, np.uint16),
    "tail": lambda: generate_flags(N - 12345, seed=23, full_range=True),
}


def jnp_twin(x):
    """The JAX kernel body's jnp twin, run eagerly: the same ops as under
    jax.jit, without jit's 35-60 s compile of the unrolled body here."""
    sums = PK._stream_sums_jnp_body(PK._pack_stream(jnp.asarray(x), 8), MODE)
    return np.asarray(sums).astype(np.int64)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_jnp_twin(case):
    x = CASES[case]()
    sums = K.stream_sums_plain(torch.from_numpy(x), MODE)
    np.testing.assert_array_equal(sums.numpy(), jnp_twin(x))
    total, fail = K._sums_to_streams(sums, report=False)
    got = assemble_counters(total, fail, x.size).numpy()
    np.testing.assert_array_equal(got, flagstat_numpy(x).astype(np.int64))


def _tiles(seed, k=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 32, size=(8, 128), dtype=np.uint32) for _ in range(k)]


def _t(a):
    return torch.from_numpy(a.view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("stages", ["full", "pruned"])
def test_transpose32_equals_jax(stages):
    st = jB.pruned_pairs() if stages == "pruned" else \
        {j: jB.swap_pairs(j) for j, _ in jB.TRANSPOSE_STAGES}
    regs = _tiles(31)
    want = PK._transpose32([jnp.asarray(r) for r in regs], st)
    got = K._transpose32([_t(r) for r in regs], st)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_u(g), np.asarray(w))


def test_csa_and_popcount_equal_jax():
    v, a, b = _tiles(32, 3)
    for w, g in zip(PK._csa(*map(jnp.asarray, (v, a, b))), K._csa(*map(_t, (v, a, b)))):
        np.testing.assert_array_equal(_u(g), np.asarray(w))
    for x in (v, np.full((8, 128), 0xFFFFFFFF, np.uint32), np.zeros((8, 128), np.uint32)):
        np.testing.assert_array_equal(K._popcount32(_t(x)).numpy(),
                                      np.asarray(PK._popcount32(jnp.asarray(x))))


def test_stream_inputs_flagstat_equal_jax():
    rows = _tiles(33)
    want = PK._stream_inputs_flagstat([jnp.asarray(r) for r in rows])
    got = K._stream_inputs_flagstat([_t(r) for r in rows])
    assert len(got) == len(want) == jB.N_STREAMS
    for (w0, w1), (g0, g1) in zip(want, got):
        np.testing.assert_array_equal(_u(g0), np.asarray(w0))
        np.testing.assert_array_equal(_u(g1), np.asarray(w1))

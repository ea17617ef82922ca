"""The port's plain kernel twin in mode "flagstat_report" (21 streams)
against the JAX kernel body's jnp twin at one shape of 8 x GROUP_WORDS,
and the report-mode stages against their JAX counterparts. Exact
(tolerance 0), compared as int64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu import flags as jF
from libflagstats_tpu.ops import bitslice as jB
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops.torch_ops import assemble_counters

MODE = "flagstat_report"
N = 8 * PK.GROUP_WORDS   # one Harley-Seal body: one jit compile for every case
CASES = {
    "flags<4096": lambda: generate_flags(N, seed=41),
    "full16bit": lambda: generate_flags(N, seed=42, full_range=True),
    "all-0xFFFF": lambda: np.full(N, 0xFFFF, np.uint16),
    "tail": lambda: generate_flags(N - 333, seed=43, full_range=True),
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
    assert sums.shape == (jB.N_REPORT_STREAMS,)
    np.testing.assert_array_equal(sums.numpy(), jnp_twin(x))
    total, fail = K._sums_to_streams(sums, report=True)
    got = assemble_counters(total, fail, x.size).numpy()
    ref = flagstat_numpy(x).astype(np.int64)
    idx = list(jF.REPORT_COUNTERS)
    np.testing.assert_array_equal(got[idx], ref[idx])
    assert (got[[1, 3, 4, 5, 17, 19, 20, 21]] == 0).all()


def _tiles(seed, k=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 32, size=(8, 128), dtype=np.uint32) for _ in range(k)]


def _t(a):
    return torch.from_numpy(a.view(np.int32))


def test_report_transpose_and_streams_equal_jax():
    regs = _tiles(44)
    st = jB.pruned_pairs(jB.REPORT_NEEDED_ROWS)
    want_rows = PK._transpose32([jnp.asarray(r) for r in regs], st)
    got_rows = K._transpose32([_t(r) for r in regs], st)
    for r in jB.REPORT_NEEDED_ROWS:
        np.testing.assert_array_equal(got_rows[r].numpy().view(np.uint32),
                                      np.asarray(want_rows[r]))
    want = PK._stream_inputs_flagstat(want_rows, report=True)
    got = K._stream_inputs_flagstat(got_rows, report=True)
    assert len(got) == len(want) == jB.N_REPORT_STREAMS
    for (w0, w1), (g0, g1) in zip(want, got):
        np.testing.assert_array_equal(g0.numpy().view(np.uint32), np.asarray(w0))
        np.testing.assert_array_equal(g1.numpy().view(np.uint32), np.asarray(w1))

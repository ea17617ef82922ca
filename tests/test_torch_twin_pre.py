"""The port's plain K2 twin (ops/kernels.stream_sums_pre_plain) against
the JAX kernel body's jnp twin with ``pre=True``
(pallas_kernels._stream_sums_jnp_body) at one shape of 8 x GROUP_WORDS
words, in full and report mode, on 32-row and packed plane tiles, and
the K2 wrapper's checks against JAX's. Packed tiles are held against the
twin with their rows scattered back into zeroed 32-row tiles. Exact
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

N = 8 * PK.GROUP_WORDS   # one Harley-Seal body of the jnp twin
CASES = {
    "tail": lambda: generate_flags(N - 4321, seed=51, full_range=True),
    "all-ones": lambda: np.full(N, 0xFFFF, np.uint16),
}


def jnp_twin(planes32: np.ndarray, report: bool) -> np.ndarray:
    """The jnp twin over 32-row tiles, run eagerly (the same ops as under
    jax.jit, without jit's compile of the unrolled body)."""
    mode = "flagstat_report" if report else "flagstat"
    sums = PK._stream_sums_jnp_body(jnp.asarray(planes32), mode, pre=True)
    return np.asarray(sums).astype(np.int64)


@pytest.mark.parametrize("packed", [False, True], ids=["rows32", "packed"])
@pytest.mark.parametrize("report", [False, True], ids=["full", "report"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_jnp_twin(case, report, packed):
    x = CASES[case]()
    full = jB.pretranspose_host_np(x)                     # (8, 32, 8, 128)
    if packed:
        rows = list(PK.packed_rows_for(report))
        planes = np.ascontiguousarray(full[:, rows])
        scattered = np.zeros_like(full)
        scattered[:, rows] = planes
        want = jnp_twin(scattered, report)
    else:
        planes = full
        want = jnp_twin(full, report)
    got = K.stream_sums_pre_plain(torch.from_numpy(planes), report, packed)
    np.testing.assert_array_equal(got.numpy(), want)
    counters = K.flagstat_cuda_pre(torch.from_numpy(planes), x.size, report,
                                   packed).numpy()
    ref = flagstat_numpy(x).astype(np.int64)
    idx = list(jF.REPORT_COUNTERS) if report else list(range(32))
    np.testing.assert_array_equal(counters[idx], ref[idx])


def test_packed_rows_equal_jax():
    assert K.PACKED_ROWS_FULL == PK.PACKED_ROWS_FULL
    assert K.PACKED_ROWS_REPORT == PK.PACKED_ROWS_REPORT
    for report in (False, True):
        assert K.packed_rows_for(report) == PK.packed_rows_for(report)


@pytest.mark.parametrize("report", [False, True], ids=["full", "report"])
def test_ragged_group_count_needs_no_padding(report):
    """JAX pads G to a multiple of nblk; the port takes any G: 3 groups
    equal the same groups padded with zero tiles to 8."""
    x = generate_flags(3 * PK.GROUP_WORDS - 99, seed=52, full_range=True)
    planes = jB.pretranspose_host_packed(x, PK.packed_rows_for(report))
    padded = np.concatenate([planes, np.zeros((5,) + planes.shape[1:], np.uint32)])
    a = K.stream_sums_pre_cuda(torch.from_numpy(planes), report, packed=True)
    b = K.stream_sums_pre_cuda(torch.from_numpy(padded), report, packed=True)
    assert torch.equal(a, b)
    got = K.flagstat_cuda_pre(torch.from_numpy(planes), x.size, report, True)
    want = flagstat_numpy(x).astype(np.int64)
    idx = list(jF.REPORT_COUNTERS) if report else list(range(32))
    np.testing.assert_array_equal(got.numpy()[idx], want[idx])


def test_wrapper_checks_match_jax():
    before = dict(K.LAUNCHES)
    full = torch.zeros((2, 32, 8, 128), dtype=torch.uint32)
    packed = torch.zeros((2, 24, 8, 128), dtype=torch.int32)
    # JAX: "expected (G, n_rows, 8, 128) plane tiles"
    for bad, is_packed in ((full, True), (packed, False)):
        with pytest.raises(ValueError, match="plane tiles"):
            PK.stream_sums_pallas_pre(jnp.zeros(tuple(bad.shape), jnp.uint32),
                                      packed=is_packed)
        with pytest.raises(ValueError, match="plane tiles"):
            K.stream_sums_pre_cuda(bad, packed=is_packed)
    with pytest.raises(ValueError, match="plane tiles"):
        K.stream_sums_pre_cuda(torch.zeros((2, 20, 8, 128), dtype=torch.int32),
                               report=False, packed=True)
    with pytest.raises(ValueError, match="uint32"):
        K.stream_sums_pre_cuda(torch.zeros((1, 32, 8, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.stream_sums_pre_cuda(torch.zeros((1, 32, 8, 128), dtype=torch.int32,
                                           device="meta"))
    for report in (False, True):
        empty = torch.zeros((0, 32, 8, 128), dtype=torch.int32)
        z = K.stream_sums_pre_cuda(empty, report)
        jt, jf = PK.stream_sums_pallas_pre(jnp.zeros((0, 32, 8, 128), jnp.uint32),
                                           report=report)
        assert not z.any() and not np.asarray(jt).any() and not np.asarray(jf).any()
        assert z.shape == (jB.N_REPORT_STREAMS if report else jB.N_STREAMS,)
    assert K.LAUNCHES == before   # the plain version is no launch

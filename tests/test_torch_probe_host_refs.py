"""The probes' numpy host references (ops/probe_kernels ``*_np``), which
the checks on the card and the stage decomposition gate the kernels
against: each equals the port's plain torch version on the same seeded
words, exactly, and the op-count table prices one call as its source
counts it."""
import numpy as np
import pytest
import torch

from libflagstats_tpu_torch.ops import bitslice as B
from libflagstats_tpu_torch.ops import probe_kernels as P
from libflagstats_tpu_torch.oracle import generate_flags

GW = P.GROUP_WORDS
SIZES = [0, 1, 129, GW - 3, 2 * GW + 777]


def pospopcnt_np(x: np.ndarray) -> np.ndarray:
    return np.array([np.count_nonzero((x.astype(np.uint32) >> k) & 1) for k in range(16)])


@pytest.mark.parametrize("n", SIZES)
def test_read_xor_np_equals_plain(n):
    x = generate_flags(n, seed=n + 1, full_range=True)
    assert P.read_xor_np(x) == P.digest(P.read_xor_plain(torch.from_numpy(x)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("repeat", [1, 2, 3])
def test_transpose_xor_np_equals_plain(n, repeat):
    x = generate_flags(n, seed=n + 2, full_range=True)
    got = P.digest(P.transpose_xor_plain(torch.from_numpy(x), repeat))
    assert P.transpose_xor_np(x, repeat) == got


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("repeat", [1, 2, 3])
def test_transform_xor_pre_np_equals_plain(n, repeat):
    planes = B.pretranspose_host(generate_flags(n, seed=n + 3, full_range=True))
    got = P.digest(P.transform_xor_pre_plain(torch.from_numpy(planes), repeat))
    assert P.transform_xor_pre_np(planes, repeat) == got


@pytest.mark.parametrize("n", SIZES[1:])
@pytest.mark.parametrize("repeat", [1, 3])
def test_stream_sums_raw_np_equals_plain(n, repeat):
    x = generate_flags(n, seed=n + 4, full_range=True)
    planes = torch.from_numpy(B.pretranspose_host(x))
    got = P.stream_sums_raw_plain(planes, repeat).numpy()
    assert (P.stream_sums_raw_np(pospopcnt_np(x), repeat) == got).all()


def test_transpose_xor_np_at_repeat_1_folds_the_transposed_planes():
    """One pruned pass leaves the NEEDED_ROWS planes of the full
    transpose, so the digest is the xor of those planes of the tiles."""
    x = generate_flags(3 * GW - 5, seed=9, full_range=True)
    planes = B.pretranspose_host(x)
    assert P.transpose_xor_np(x) == int(np.bitwise_xor.reduce(planes[:, P.FOLD_ROWS].ravel()))


def test_probe_ops_count_the_source():
    assert P.probe_ops("transpose_xor") == {"alu": (56 * 6 + 24) / 64}
    assert P.probe_ops("transform_xor", 1) == {"alu": (16 + 12 + 14 + 29) / 32}
    assert P.probe_ops("raw", 4) == {"alu": 4 * 60 / 32, "popc": 4 * 29 / 32}
    assert P.probe_ops("read_xor", 8) == {"alu": 0.5}
    assert set(P.PLANE_ROWS_READ) <= set(P.PROBE_OPS)

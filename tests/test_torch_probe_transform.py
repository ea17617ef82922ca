"""K7c, the transform probe: the port's plain version and its CUDA wrapper
on a CPU tensor against the JAX Pallas kernel in interpret mode, on the
same seeded plane tiles (8 groups, and a ragged 5), at repeat 1 and 2;
and the shape and empty-input behaviour of both. Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu import flags as jF
from libflagstats_tpu.ops import bitslice as jB
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import generate_flags
from libflagstats_tpu_torch.ops import probe_kernels as P


def host_fold(planes: np.ndarray, repeat: int) -> int:
    fold = np.zeros(planes.shape[:1] + planes.shape[2:], np.uint32)
    for half_of in (jB.first_half_row, jB.second_half_row):
        p = [planes[:, half_of(j)] for j in range(12)]
        for _ in range(repeat):
            t = jB.transform_planes(p)
            p = t[:12]
        q = t[jF.FQCFAIL_OFF]
        for k in jB.C_STREAMS:
            fold ^= t[k]
        for k in jB.F_STREAMS:
            fold ^= t[k] & q
    return int(np.bitwise_xor.reduce(fold.ravel()))


@pytest.mark.parametrize("n", [8 * PK.GROUP_WORDS, 5 * PK.GROUP_WORDS - 777],
                         ids=["8-groups", "ragged-5-groups"])
@pytest.mark.parametrize("repeat", [1, 2])
def test_transform_xor_equals_pallas_interpret(n, repeat):
    planes = jB.pretranspose_host(generate_flags(n, seed=31, full_range=True))
    want = int(np.asarray(PK.transform_xor_pallas_pre(jnp.asarray(planes), interpret=True,
                                                      repeat=repeat))[0])
    pt = torch.from_numpy(planes)
    assert P.digest(P.transform_xor_pre_plain(pt, repeat)) == want
    assert P.digest(P.transform_xor_pre_cuda(pt, repeat)) == want
    assert P.digest(P.transform_xor_pre_cuda(pt.view(torch.int32), repeat)) == want
    assert host_fold(planes, repeat) == want


def test_transform_xor_shape_errors_match():
    bad = np.zeros((1, 32, 4, 128), np.uint32)
    with pytest.raises(ValueError, match="plane tiles"):
        PK.transform_xor_pallas_pre(jnp.asarray(bad))
    for t in (torch.from_numpy(bad), torch.zeros((2, 24, 8, 128), dtype=torch.int32),
              torch.zeros((32, 8, 128), dtype=torch.int32)):
        with pytest.raises(ValueError, match="plane tiles"):
            P.transform_xor_pre_cuda(t)
        with pytest.raises(ValueError, match="plane tiles"):
            P.transform_xor_pre_plain(t)


def test_transform_xor_empty():
    want = np.asarray(PK.transform_xor_pallas_pre(jnp.zeros((0, 32, 8, 128), jnp.uint32),
                                                  interpret=True))
    got = P.transform_xor_pre_cuda(torch.zeros((0, 32, 8, 128), dtype=torch.int32))
    assert got.shape == (1,) and P.digest(got) == int(want[0]) == 0

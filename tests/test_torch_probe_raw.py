"""K7a, the count probe: the port's plain version and its CUDA wrapper on
a CPU tensor against the JAX Pallas kernel (mode "flagstat_raw" /
"flagstat_raw@N") in interpret mode, on the same seeded plane tiles (8
groups, and a ragged 5), at repeat 1 and 2; the positional-popcount
meaning of its entries; and the empty, shape and repeat-overflow errors
of both packages. Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import bitslice as jB
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import generate_flags
from libflagstats_tpu_torch.ops import probe_kernels as P

from conftest import pospopcnt_ref


@pytest.mark.parametrize("n", [8 * PK.GROUP_WORDS, 5 * PK.GROUP_WORDS - 777],
                         ids=["8-groups", "ragged-5-groups"])
@pytest.mark.parametrize("repeat", [1, 2])
def test_stream_sums_raw_equals_pallas_interpret(n, repeat):
    x = generate_flags(n, seed=37, full_range=True)
    planes = jB.pretranspose_host(x)
    want = np.asarray(PK.stream_sums_pallas_raw(jnp.asarray(planes), interpret=True,
                                                repeat=repeat)).astype(np.int64)
    pt = torch.from_numpy(planes)
    for got in (P.stream_sums_raw_plain(pt, repeat), P.stream_sums_raw_cuda(pt, repeat)):
        assert got.dtype == torch.int64 and got.shape == (32,)
        np.testing.assert_array_equal(got.numpy(), want)
    pos = pospopcnt_ref(x)
    expect = np.zeros(32, np.int64)
    expect[:29] = [pos[k] for k in jB.C_STREAMS + jB.F_STREAMS]
    np.testing.assert_array_equal(want, repeat * expect)


def test_stream_sums_raw_repeat_overflow_matches():
    """The JAX function refuses a repeat past its int32 accumulators; the
    port refuses the same inputs with the same message."""
    planes = np.zeros((1024, 32, 8, 128), np.uint32)   # 64Mi words: max repeat 31
    with pytest.raises(ValueError) as jax_err:
        PK.stream_sums_pallas_raw(jnp.asarray(planes), repeat=32)
    pt = torch.from_numpy(planes)
    for fn in (P.stream_sums_raw_plain, P.stream_sums_raw_cuda):
        with pytest.raises(ValueError) as port_err:
            fn(pt, 32)
        assert str(port_err.value) == str(jax_err.value)
    assert "max 31 for 1024 groups" in str(jax_err.value)
    with pytest.raises(ValueError, match="repeat"):
        P.stream_sums_raw_cuda(torch.zeros((1, 32, 8, 128), dtype=torch.int32), 0)


def test_stream_sums_raw_shape_and_empty():
    with pytest.raises(ValueError, match="plane tiles"):
        PK.stream_sums_pallas_raw(jnp.zeros((4, 2, 8, 128), jnp.uint32))
    with pytest.raises(ValueError, match="plane tiles"):
        P.stream_sums_raw_cuda(torch.zeros((4, 2, 8, 128), dtype=torch.int32))
    want = np.asarray(PK.stream_sums_pallas_raw(jnp.zeros((0, 32, 8, 128), jnp.uint32),
                                                interpret=True))
    got = P.stream_sums_raw_cuda(torch.zeros((0, 32, 8, 128), dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == 0).all() and got.shape == (32,)

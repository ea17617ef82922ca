"""K4, the read roofline: the port's plain version and its CUDA wrapper on
a CPU tensor against the JAX Pallas kernel run in interpret mode, on the
same seeded words, and against the host rule (the xor of the words with
(i >> 7) & 1 == 0 in the low half, of the others in the high half).
Exact (tolerance 0), the full 32-bit digest."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import generate_flags
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import probe_kernels as P


def parity_digest(x: np.ndarray) -> int:
    i = np.arange(x.size)
    even = np.bitwise_xor.reduce(x[(i >> 7) & 1 == 0].astype(np.uint32), initial=0)
    odd = np.bitwise_xor.reduce(x[(i >> 7) & 1 == 1].astype(np.uint32), initial=0)
    return int(even) | int(odd) << 16


@pytest.mark.parametrize("n", [16 * PK.GROUP_WORDS, 8 * PK.GROUP_WORDS - 4321],
                         ids=["two-steps", "ragged"])
def test_read_xor_equals_pallas_interpret(n):
    x = generate_flags(n, seed=n % 97, full_range=True)
    want = int(np.asarray(PK.read_xor_pallas(jnp.asarray(x), interpret=True))[0])
    assert want == parity_digest(x)
    xt = torch.from_numpy(x)
    before = dict(K.LAUNCHES)
    for got in (P.read_xor_plain(xt), P.read_xor_cuda(xt), P.read_xor_cuda(xt.view(torch.int16))):
        assert got.shape == (1,) and got.dtype == torch.int32
        assert P.digest(got) == want
    assert K.LAUNCHES == before  # the plain version is no launch


@pytest.mark.parametrize("n", [1, 127, 128, 129, 255, 256, 1000, 65537])
def test_read_xor_small_lengths_follow_the_row_rule(n):
    x = generate_flags(n, seed=n, full_range=True)
    assert P.digest(P.read_xor_plain(torch.from_numpy(x))) == parity_digest(x)


def test_read_xor_odd_offset_slice():
    x = generate_flags(3 * 1024 + 5, seed=3, full_range=True)
    buf = torch.from_numpy(np.concatenate([np.zeros(1, np.uint16), x]))
    assert P.digest(P.read_xor_cuda(buf[1:])) == parity_digest(x)


def test_read_xor_empty():
    want = np.asarray(PK.read_xor_pallas(jnp.zeros(0, jnp.uint16), interpret=True))
    got = P.read_xor_cuda(torch.zeros(0, dtype=torch.int16))
    assert got.shape == (1,) and P.digest(got) == int(want[0]) == 0


def test_read_xor_is_not_a_uint32_view_fold():
    """The sublane pairing gives another digest than xor-folding a plain
    uint32 view of the words."""
    x = generate_flags(4096, seed=5, full_range=True)
    plain_view = int(np.bitwise_xor.reduce(x.view(np.uint32)))
    assert P.digest(P.read_xor_plain(torch.from_numpy(x))) != plain_view


def test_read_xor_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.read_xor_cuda(torch.zeros(64, dtype=torch.int16, device="meta"))
    with pytest.raises(ValueError, match="uint16"):
        P.read_xor_cuda(torch.zeros(64, dtype=torch.int32))
    with pytest.raises(TypeError):
        P.read_xor_cuda(np.zeros(64, np.uint16))

"""K7b, the transpose probe, at 8 x GROUP_WORDS words: the port's plain
version and its CUDA wrapper on a CPU tensor against the JAX Pallas
kernel in interpret mode (~20-50 s a call here, so the ragged length is
in test_torch_probe_transpose_ragged.py), at repeat 1 and 2. Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import bitslice as jB
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import generate_flags
from libflagstats_tpu_torch.ops import probe_kernels as P

N = 8 * PK.GROUP_WORDS


def host_chain(x: np.ndarray, repeat: int) -> int:
    """tests/test_stage_probes.py's host twin: the pruned network chained
    from the sublane-paired registers, then the NEEDED_ROWS fold."""
    x = np.concatenate([x, np.zeros((-x.size) % PK.GROUP_WORDS, np.uint16)])
    t = x.reshape(-1, 32, 16, 128)
    regs = t[:, :, 0::2, :].astype(np.uint32) | (t[:, :, 1::2, :].astype(np.uint32) << 16)
    rows = [regs[:, k] for k in range(32)]
    for _ in range(repeat):
        rows = jB.transpose32_np(rows, prune=True)
    fold = np.zeros(regs.shape[:1] + regs.shape[2:], np.uint32)
    for r in sorted(jB.NEEDED_ROWS):
        fold ^= rows[r]
    return int(np.bitwise_xor.reduce(fold.ravel()))


@pytest.mark.parametrize("repeat", [1, 2])
def test_transpose_xor_equals_pallas_interpret(repeat):
    x = generate_flags(N, seed=23, full_range=True)
    want = int(np.asarray(PK.transpose_xor_pallas(jnp.asarray(x), interpret=True,
                                                  repeat=repeat))[0])
    xt = torch.from_numpy(x)
    assert P.digest(P.transpose_xor_plain(xt, repeat)) == want
    assert P.digest(P.transpose_xor_cuda(xt, repeat)) == want
    assert host_chain(x, repeat) == want


@pytest.mark.parametrize("repeat", [3, 8])
def test_transpose_xor_longer_chains_equal_the_host_twin(repeat):
    x = generate_flags(2 * PK.GROUP_WORDS + 999, seed=repeat, full_range=True)
    assert P.digest(P.transpose_xor_plain(torch.from_numpy(x), repeat)) == host_chain(x, repeat)


def test_transpose_xor_empty_and_bad_repeat():
    want = np.asarray(PK.transpose_xor_pallas(jnp.zeros(0, jnp.uint16), interpret=True))
    assert P.digest(P.transpose_xor_cuda(torch.zeros(0, dtype=torch.int16))) == int(want[0]) == 0
    for repeat in (0, -1, 2.0):
        with pytest.raises(ValueError, match="repeat"):
            P.transpose_xor_cuda(torch.zeros(8, dtype=torch.int16), repeat)

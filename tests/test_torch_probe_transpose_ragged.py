"""K7b, the transpose probe, at a ragged length (8 x GROUP_WORDS - 4,321
words, zero-padded to whole groups): the port's plain version and its
CUDA wrapper on a CPU tensor against the JAX Pallas kernel in interpret
mode, at repeat 1 and 2. Exact. A file of its own so that the two
interpret-mode files run side by side under --dist loadfile."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import generate_flags
from libflagstats_tpu_torch.ops import probe_kernels as P

N = 8 * PK.GROUP_WORDS - 4321


@pytest.mark.parametrize("repeat", [1, 2])
def test_transpose_xor_ragged_equals_pallas_interpret(repeat):
    x = generate_flags(N, seed=29, full_range=True)
    want = int(np.asarray(PK.transpose_xor_pallas(jnp.asarray(x), interpret=True,
                                                  repeat=repeat))[0])
    xt = torch.from_numpy(x)
    assert P.digest(P.transpose_xor_plain(xt, repeat)) == want
    buf = torch.from_numpy(np.concatenate([np.zeros(1, np.uint16), x]))
    assert P.digest(P.transpose_xor_cuda(buf[1:], repeat)) == want

"""K2's plain version against the JAX Pallas kernel itself, run in
interpret mode, on packed 24-row full-mode tiles of 8 x GROUP_WORDS - 4,321
words: one shape, as an interpret-mode run takes ~10 s here. Exact
(tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import torch

from libflagstats_tpu import flags as jF
from libflagstats_tpu.ops import bitslice as jB
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.ops import bitslice as tB
from libflagstats_tpu_torch.ops import kernels as K

REPORT = False


def test_packed_full_equals_pallas_interpret():
    n = 8 * PK.GROUP_WORDS - 4321
    x = generate_flags(n, seed=61, full_range=True)
    rows = PK.packed_rows_for(REPORT)
    jplanes = jB.pretranspose_host_packed(x, rows)
    tplanes = tB.pretranspose_host_packed(x, K.packed_rows_for(REPORT))
    np.testing.assert_array_equal(tplanes, jplanes)
    want = np.asarray(PK.flagstat_pallas_pre(jnp.asarray(jplanes), n=n,
                                             interpret=True, packed=True,
                                             report=REPORT)).astype(np.int64)
    got = K.flagstat_cuda_pre(torch.from_numpy(tplanes), n, REPORT, packed=True).numpy()
    idx = list(jF.REPORT_COUNTERS) if REPORT else list(range(32))
    np.testing.assert_array_equal(got[idx], want[idx])
    np.testing.assert_array_equal(got[idx], flagstat_numpy(x).astype(np.int64)[idx])

"""K6, the word-space kernel (ops/words_kernels.py): the port's plain
version and the ``cuda_words`` impl against the JAX package's
``stream_sums_words`` (the Pallas kernel in interpret mode) and
flagstat_numpy on the same seeded inputs. On a CPU tensor the kernel
wrapper takes the plain version. Exact (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import words_kernels as W

SIZES = [0, 1, PK.WORDS_STEP - 777, 2 * PK.WORDS_STEP + 31]


@pytest.mark.parametrize("n", SIZES)
def test_plain_and_impl_equal_jax_words_kernel(n, full_range, monkeypatch):
    x = generate_flags(n, seed=n + 90, full_range=full_range)
    if n > 2 * PK.WORDS_STEP:
        # three chunked JAX calls; the port's plain version takes 5 turns
        # of 1024 bodies and flushes its packed halves after turns 2 and 4
        monkeypatch.setattr(PK, "_WORDS_MAX_STEPS", 1)
        monkeypatch.setattr(W, "FLUSH_BODIES", 2)
        monkeypatch.setattr(W, "PLAIN_THREADS", 1024)
    jt, jf = PK.stream_sums_words(jnp.asarray(x), interpret=True)
    before = dict(K.LAUNCHES)
    for t, f in (W.stream_sums_words_plain(x), W.stream_sums_words_cuda(torch.from_numpy(x))):
        assert t.dtype == f.dtype == torch.int64 and t.shape == f.shape == (16,)
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert K.LAUNCHES == before   # the plain version is no launch
    ref = flagstat_numpy(x)
    np.testing.assert_array_equal(L.flagstats_u16(x, impl="cuda_words", device="cpu"), ref)
    np.testing.assert_array_equal(W.flagstat_cuda_words(torch.from_numpy(x)).numpy(),
                                  ref.astype(np.int64))


@pytest.mark.parametrize("flush,exact", [(4095, True), (10 ** 9, False)],
                         ids=["kernel-bound", "no-flush"])
def test_flush_interval_is_the_packed_half_bound(monkeypatch, flush, exact):
    """One thread, 4096 bodies of 0x0FFF (a QC-fail word whose
    transformed bits 2, 8, 9 and 10 are set): the sixteens peel adds 16
    per body, so without a flush the fail stratum's fields wrap at
    16 * 4096 = 65,536; a flush every 4095 bodies keeps them exact."""
    monkeypatch.setattr(W, "PLAIN_THREADS", 1)
    monkeypatch.setattr(W, "FLUSH_BODIES", flush)
    x = np.full(4096 * W.BODY_WORDS, 0x0FFF, dtype=np.uint16)
    got = W.flagstat_cuda_words(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, flagstat_numpy(x).astype(np.int64)) == exact


def test_device_word_cap_chunks_exactly(monkeypatch):
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 1000)
    x = generate_flags(4321, seed=91, full_range=True)
    np.testing.assert_array_equal(L.flagstats_u16(x, impl="cuda_words", device="cpu"),
                                  flagstat_numpy(x))


def test_wrapper_routes_only_cpu_tensors_to_plain():
    x = torch.from_numpy(generate_flags(5000, seed=92, full_range=True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        W.stream_sums_words_cuda(torch.zeros(64, dtype=torch.int16, device="meta"))
    with pytest.raises(ValueError, match="uint16"):
        W.stream_sums_words_cuda(x.to(torch.int32))
    with pytest.raises(ValueError, match="blocks"):
        W.stream_sums_words_cuda(x, blocks=0)
    with pytest.raises(TypeError):
        W.stream_sums_words_cuda(x.numpy())
    # an odd-offset slice counts exactly
    odd = x[1:]
    t, f = W.stream_sums_words_cuda(odd, blocks=3)
    c = W.flagstat_cuda_words(odd).numpy()
    np.testing.assert_array_equal(c, flagstat_numpy(odd.numpy()).astype(np.int64))
    assert t[15] == f[15] == 0

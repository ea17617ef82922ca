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
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags, transform_words

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.ops import words_kernels as W
from libflagstats_tpu_torch.ops.torch_ops import _transform_words_packed

SIZES = [0, 1, PK.WORDS_STEP - 777, 2 * PK.WORDS_STEP + 31]


@pytest.mark.parametrize("n", SIZES)
def test_plain_and_impl_equal_jax_words_kernel(n, full_range, monkeypatch):
    x = generate_flags(n, seed=n + 90, full_range=full_range)
    if n > 2 * PK.WORDS_STEP:
        # three chunked JAX calls; the port's plain version takes 33 turns
        # of 128 threads, peels its level-2 tree after turns 8, 16, 24 and
        # 32, flushes its packed halves after each peel, and ends with a
        # carry pending
        monkeypatch.setattr(PK, "_WORDS_MAX_STEPS", 1)
        monkeypatch.setattr(W, "FLUSH_BODIES", 16)
        monkeypatch.setattr(W, "PLAIN_THREADS", 128)
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


@pytest.mark.parametrize("value", [0x0FFF, 0x0DFF], ids=["qcfail-0x0FFF", "pass-0x0DFF"])
@pytest.mark.parametrize("flush,exact", [(W.FLUSH_BODIES, True), (W.FLUSH_BODIES + 16, False)],
                         ids=["kernel-bound", "one-peel-past"])
def test_flush_interval_is_the_packed_half_bound(monkeypatch, flush, exact, value):
    """One thread, 256 level-2 peels of one repeated word (0x0FFF: a
    QC-fail word, transformed bits 2, 8, 9, 10 in the high fields; 0x0DFF:
    a QC-pass word, bits 2, 8, 10 in the low fields): each peel adds 256
    to those fields, so flushed every 255 peels (4080 bodies) they stay
    exact, and one peel later (4096 bodies) they wrap at 256 * 256."""
    monkeypatch.setattr(W, "PLAIN_THREADS", 1)
    monkeypatch.setattr(W, "FLUSH_BODIES", flush)
    assert W.FLUSH_BODIES // 16 == 255 + (not exact)
    x = np.full(256 * 16 * W.BODY_WORDS, value, dtype=np.uint16)
    got = W.flagstat_cuda_words(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, flagstat_numpy(x).astype(np.int64)) == exact


def test_flush_interval_must_be_whole_level2_bodies(monkeypatch):
    monkeypatch.setattr(W, "FLUSH_BODIES", 24)
    with pytest.raises(ValueError, match="multiple of 16"):
        W.stream_sums_words_plain(np.zeros(64, np.uint16))


@pytest.mark.parametrize("high", [0, 0xF000], ids=["bits12-15-clear", "bits12-15-set"])
def test_table_is_the_swar_transform(high):
    """Entry x & 0xFFF of the kernel's table is the packed-SWAR transform
    of x (the port's and the JAX package's) split by QC-fail into the low
    or high field, for every 12-bit x with input bits 12-15 clear or set;
    the oracle's word transform agrees."""
    table = W.word_table()
    assert table.shape == (4096,) and table.dtype == torch.int32
    x = np.arange(4096, dtype=np.uint32) | high
    tp, tf = _transform_words_packed(torch.from_numpy(x.astype(np.int32)))
    want = ((tp & 0xFFFF) | ((tf & 0xFFFF) << 16)).numpy()
    np.testing.assert_array_equal(table[torch.from_numpy((x & 0xFFF).astype(np.int64))].numpy(),
                                  want)
    jp, jf = PK._transform_words_packed(jnp.asarray(x))
    np.testing.assert_array_equal(want.view(np.uint32),
                                  (np.asarray(jp) & 0xFFFF) | (np.asarray(jf) << 16))
    t = transform_words(x.astype(np.uint16))
    qc = (x >> F.FQCFAIL_OFF) & 1
    np.testing.assert_array_equal(want.view(np.uint32),
                                  np.where(qc, t.astype(np.uint32) << 16, t))


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

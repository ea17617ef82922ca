"""The port's streaming flagstat (io/stream.flagstat_stream) in every impl
equals the JAX package's stream (impl="native") and flagstat_numpy on
the same framed files: the kernel impls on device="cpu" run their plain
versions through the whole pipeline (staging, transpose stage, ring,
epoch roll). "cuda_card" is impl="cuda" on the path a CUDA device takes
for an LZ4 file, where the card decodes the frames (here the decode
kernel's plain version). Exact."""
import numpy as np
import pytest
import torch

import libflagstats_tpu.io.stream as jS
from libflagstats_tpu import flags as jF
from libflagstats_tpu.io import codec as jC
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.bench.profiling import SectionTimer
from libflagstats_tpu_torch.io import stream as S
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K

GW = K.GROUP_WORDS
IMPLS = {
    "native": {},
    "torch": {},
    "cuda": {"device": "cpu"},
    "cuda_pre": {"device": "cpu"},
    "cuda_card": {"device": "cpu"},
}


def engage(impl, monkeypatch):
    """The impl to pass for ``impl``: "cuda_card" is "cuda" on the CPU
    with the frames decoded as on a CUDA device, by the decode kernel's
    plain version."""
    if impl != "cuda_card":
        return impl
    card = S._card_decodes
    monkeypatch.setattr(S, "_card_decodes",
                        lambda codec, impl, dev: card(codec, impl, torch.device("cuda")))
    return "cuda"


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    """3 groups + a tail, in 30,000-byte blocks that never align with the
    65,536-word chunks."""
    x = generate_flags(3 * GW + 18_928, seed=81, full_range=True)
    path = tmp_path_factory.mktemp("s") / "s.lz4"
    jC.write_framed(path, x, codec="lz4", level=1, block_bytes=30_000)
    return path, x


@pytest.mark.parametrize("impl", list(IMPLS))
def test_stream_equals_jax_and_oracle(stream_file, monkeypatch, impl):
    path, x = stream_file
    timer = SectionTimer()
    before = dict(S.CARD_DECODE)
    got = L.flagstat_stream(path, "lz4", impl=engage(impl, monkeypatch), chunk_words=GW,
                            timer=timer, **IMPLS[impl])
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, jS.flagstat_stream(path, "lz4", impl="native"))
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    decoded = {k: S.CARD_DECODE[k] - before[k] for k in before}
    if impl == "cuda_card":
        # 15 frames of 15,000 words that hardly compress, four to a run
        # of at most 2 * GW bytes, each copied in two parts (8 decode
        # threads, 4 runs at once); a launch a run, since 3 frames (a
        # CPU's one "SM") land and as many are still to come each time
        assert decoded == {"card_frames": 15, "host_frames": 0, "launches": 4}
        assert timer.counts["dispatch"] == timer.counts["decode_wait"] == 4
        assert timer.counts["decode"] == 8
        assert "ms total" in timer.report()
    elif impl != "native":
        assert decoded == {"card_frames": 0, "host_frames": 15, "launches": 0}
        assert timer.counts["dispatch"] == 4       # 3 whole chunks + the padded tail
        assert "ms total" in timer.report()
    if impl == "cuda_pre":
        assert timer.counts["transpose_wait"] == 4


@pytest.mark.parametrize("impl", ["cuda", "cuda_pre", "torch", "cuda_card"])
def test_report_mode(stream_file, monkeypatch, impl):
    path, x = stream_file
    got = L.flagstat_stream(path, "lz4", impl=engage(impl, monkeypatch), chunk_words=GW,
                            report=True, **IMPLS[impl]).astype(np.int64)
    ref = flagstat_numpy(x).astype(np.int64)
    idx = list(jF.REPORT_COUNTERS)
    np.testing.assert_array_equal(got[idx], ref[idx])
    if impl == "torch":       # the plain word-space tier counts all 32 either way
        np.testing.assert_array_equal(got, ref)
    else:
        assert not got[[1, 3, 4, 5, 17, 19, 20, 21]].any()


@pytest.mark.parametrize("impl", ["torch", "cuda_pre"])
def test_zstd_and_larger_chunks(tmp_path, impl):
    x = generate_flags(123_457, seed=82)
    path = tmp_path / "s.zst"
    jC.write_framed(path, x, codec="zstd", level=3)
    got = L.flagstat_stream(path, "zstd", impl=impl, chunk_words=2 * GW,
                            **IMPLS[impl])
    np.testing.assert_array_equal(got, flagstat_numpy(x))


@pytest.mark.parametrize("impl", ["torch", "cuda", "cuda_pre", "cuda_card"])
def test_epoch_roll_past_device_cap(tmp_path, monkeypatch, impl):
    """With a tiny DEVICE_WORD_CAP the device sums roll into the host
    grand total every few chunks and stay exact."""
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 150_000)
    x = generate_flags(1_000_003, seed=83, full_range=True)
    path = tmp_path / "cap.lz4"
    jC.write_framed(path, x, codec="lz4", level=1)
    got = L.flagstat_stream(path, "lz4", impl=engage(impl, monkeypatch), chunk_words=GW,
                            **IMPLS[impl])
    np.testing.assert_array_equal(got, flagstat_numpy(x))


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="multiple"):
        L.flagstat_stream("/nonexistent", impl="cuda_pre", chunk_words=1000,
                          device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        L.flagstat_stream("/nonexistent", impl="pallas")
    with pytest.raises(ValueError, match="positive"):
        L.flagstat_stream("/nonexistent", impl="torch", chunk_words=0)


def test_auto_impl_is_native_when_the_library_builds(stream_file):
    """The default stream counts on the card: with none it raises rather
    than falling back to the host. The fused native stream is there by
    name and equals the JAX package's."""
    path, x = stream_file
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.flagstat_stream(path, "lz4")
    timer = SectionTimer()
    got = L.flagstat_stream(path, "lz4", impl="native", timer=timer)
    assert "decode_count" in timer.totals       # the fused native pipeline ran
    np.testing.assert_array_equal(got, jS.flagstat_stream(path, "lz4", impl="native"))
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    np.testing.assert_array_equal(L.flagstat_stream(path, "lz4", chunk_words=GW, device="cpu"),
                                  got)           # device="cpu" picks the torch tier
    assert S.DEVICE_IMPLS == ("torch", "cuda", "cuda_pre")

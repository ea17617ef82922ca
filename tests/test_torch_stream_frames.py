"""The device stream's runs of whole frames (io/stream.py): every device
impl (the kernel impls on device="cpu", running their plain versions)
equals the JAX package's stream (impl="native" and impl="xla") and
flagstat_numpy on the same framed files, for each codec and every run
geometry; for "torch" and "cuda" the decoder writes only into the ring's
slots; bad headers, truncated tails, trailing bytes and corrupt payloads
raise what the JAX stream raises and leave the checkpoint file it
leaves; without the native library the same loop decodes frame by
frame. "cuda_card" is impl="cuda" where the card decodes an LZ4 file's
frames (here the decode kernel's plain version): its runs, launches,
buffers and checkpoints give the same counts and errors. Exact."""
import struct

import numpy as np
import pytest
import torch

import libflagstats_tpu.io.stream as jS
from libflagstats_tpu import flags as F
from libflagstats_tpu.io import codec as jC
from libflagstats_tpu.ops import bitslice as jB
from libflagstats_tpu.ops import dispatch as jD
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.bench.profiling import SectionTimer
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.io import stream as S
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from test_torch_stream import engage

GW = K.GROUP_WORDS
IMPLS = {"torch": {}, "cuda": {"device": "cpu"}, "cuda_pre": {"device": "cpu"},
         "cuda_card": {"device": "cpu"}}
CODECS = {"raw": 0, "lz4": 1, "zstd": 3}     # codec -> level
EPOCH_CAP = 100_000

#: geometry -> (words, block_bytes or None for the default, device runs at
#: chunk_words=GW); the runs are counted by hand from the frame sizes
GEOMETRIES = {
    # 12,345-word frames, five to a run: frames never align with a chunk
    "unaligned": (200_003, 2 * 12_345, 4),
    # 100,000-word frames: each larger than the chunk, each a run alone
    "frame_above_chunk": (250_001, 2 * 100_000, 3),
    # four 16,384-word frames: exactly one chunk
    "one_chunk": (GW, 2 * 16_384, 1),
    "one_frame": (40_000, None, 1),
    "empty": (0, None, 0),
    # 20,000-word frames, three to a run; the epoch rolls before each run
    # past the first (EPOCH_CAP on both packages)
    "epoch_roll": (400_009, 2 * 20_000, 7),
}


@pytest.fixture(scope="module")
def framed(tmp_path_factory):
    """(codec, geometry) -> (path, words, the JAX stream's native and
    xla counters), written and counted by the JAX package once."""
    d = tmp_path_factory.mktemp("frames")
    cache = {}

    def get(codec, geometry):
        if (codec, geometry) not in cache:
            n, block_bytes, _ = GEOMETRIES[geometry]
            x = generate_flags(n, seed=1500 + n % 97, full_range=True)
            path = d / f"{geometry}.{codec}"
            jC.write_framed(path, x, codec=codec, level=CODECS[codec], block_bytes=block_bytes)
            cap = jD.DEVICE_WORD_CAP
            if geometry == "epoch_roll":
                jD.DEVICE_WORD_CAP = EPOCH_CAP
            try:
                xla = jS.flagstat_stream(path, codec, impl="xla", chunk_words=GW)
            finally:
                jD.DEVICE_WORD_CAP = cap
            cache[codec, geometry] = (path, x, jS.flagstat_stream(path, codec, impl="native"),
                                      xla)
        return cache[codec, geometry]

    return get


def card_runs(path, codec, threads: int = 8) -> tuple[int, int]:
    """(runs, copies) of the card path over ``path`` at chunk_words=GW:
    runs of whole frames of at most 2 * GW bytes of the file, or one
    frame, each copied in as many parts as the decode threads allow."""
    src = S._FramedFile(path, codec)
    try:
        runs = list(src.runs(0, len(src.frames), S.DECODE_WORDS, 0, 2 * GW))
        parts = max(threads // min(S.DECODE_CALLS, threads), 1)
        return len(runs), sum(min(parts, src.span(a, b)) for a, b in runs)
    finally:
        src.close()


def counted(monkeypatch, impl, codec, run):
    """(result, timer, moves of ``stream.CARD_DECODE``) of
    ``run(impl, timer)`` for ``impl``, after checking where the frames
    decoded: for "cuda_card" over an LZ4 file on the card path (a
    dispatch a decode launch), else on the host."""
    timer = SectionTimer()
    before = dict(S.CARD_DECODE)
    got = run(engage(impl, monkeypatch), timer)
    decoded = {k: S.CARD_DECODE[k] - before[k] for k in before}
    if impl == "cuda_card" and codec == "lz4":
        assert decoded["host_frames"] == 0 and decoded["launches"] == timer.counts.get(
            "dispatch", 0)
    else:
        assert decoded["card_frames"] == decoded["launches"] == 0
    return got, timer, decoded


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("impl", list(IMPLS))
def test_runs_equal_jax_and_oracle(framed, monkeypatch, impl, codec, geometry):
    path, x, jax_native, jax_xla = framed(codec, geometry)
    if geometry == "epoch_roll":
        monkeypatch.setattr(D, "DEVICE_WORD_CAP", EPOCH_CAP)
    got, timer, decoded = counted(
        monkeypatch, impl, codec, lambda impl, timer: L.flagstat_stream(
            path, codec, impl=impl, chunk_words=GW, timer=timer, **IMPLS[impl]))
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    np.testing.assert_array_equal(got, jax_native)
    np.testing.assert_array_equal(got, jax_xla)
    if impl == "cuda_card" and codec == "lz4":
        runs, copies = card_runs(path, codec)
        assert decoded["card_frames"] == len(list(jC.iter_framed(path)))
        assert timer.counts.get("decode_wait", 0) == runs
        assert timer.counts.get("decode", 0) == copies
        return
    runs = GEOMETRIES[geometry][2]
    assert timer.counts.get("dispatch", 0) == runs
    assert timer.counts.get("decode", 0) == runs
    assert "chunk_copy" not in timer.totals
    assert timer.counts.get("decode_wait", 0) == runs   # the calling thread waits once a run
    if impl == "cuda_pre":
        assert timer.counts.get("transpose_wait", 0) == runs


class _Recorder:
    """The port's native library, with every destination address handed
    to lfs_decode_stream recorded."""

    def __init__(self, lib):
        self._lib = lib
        self.dst = []

    def lfs_decode_stream(self, stream, n, dst, cap, codec, threads):
        self.dst.append((dst, cap))
        return self._lib.lfs_decode_stream(stream, n, dst, cap, codec, threads)

    def __getattr__(self, name):
        return getattr(self._lib, name)


@pytest.mark.parametrize("geometry", ["unaligned", "frame_above_chunk", "epoch_roll"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_decoder_writes_only_into_ring_slots(framed, monkeypatch, impl, geometry):
    """No intermediate buffer: each run is decoded straight into a slot,
    with the slot's whole capacity as the bound."""
    lib = native_lib.load()
    assert lib is not None, native_lib.BUILD_ERROR
    recorder = _Recorder(lib)
    monkeypatch.setattr(native_lib, "load", lambda: recorder)
    rings = []

    class Ring(S._Ring):
        def __init__(self, *args):
            super().__init__(*args)
            rings.append(self)

    monkeypatch.setattr(S, "_Ring", Ring)
    if geometry == "epoch_roll":
        monkeypatch.setattr(D, "DEVICE_WORD_CAP", EPOCH_CAP)
    path, x, _, _ = framed("lz4", geometry)
    got = L.flagstat_stream(path, "lz4", impl=impl, chunk_words=GW, **IMPLS[impl])
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    assert len(rings) == 1
    slots = [(h.data_ptr(), h.numel() * h.element_size()) for h in rings[0].host]
    # the slots in turn, each with its whole capacity as the bound (runs
    # decode on several threads at once, so in any order)
    assert sorted(recorder.dst) == sorted(slots[i % len(slots)]
                                          for i in range(GEOMETRIES[geometry][2]))


# ---- errors and checkpoints ----

EVERY = 4        # checkpoint interval, in blocks
GOOD = 11        # good frames before the fault: the last boundary, 8, lies
#                  at least one decode-ahead window (4 frames with threads=1)
#                  before it, so the JAX stream has counted up to it too


@pytest.fixture(scope="module")
def good(tmp_path_factory):
    """12 one-group frames, and their headers and payloads."""
    d = tmp_path_factory.mktemp("faults")
    x = generate_flags(12 * GW, seed=1511, full_range=True)
    path = d / "good.lz4"
    jC.write_framed(path, x, codec="lz4", level=1, block_bytes=2 * GW)
    return path, x, list(jC.iter_framed(path))


def _write(path, frames, tail=b""):
    with open(path, "wb") as f:
        for raw_len, payload in frames:
            f.write(struct.pack("<ii", raw_len, len(payload)))
            f.write(payload)
        f.write(tail)
    return path


def _cut_payload(frames):
    raw_len, payload = frames[GOOD]
    return struct.pack("<ii", raw_len, len(payload)) + payload[:100]


#: fault -> the bytes after the GOOD frames
FAULTS = {
    "payload_cut": _cut_payload,
    "header_cut": lambda frames: b"\x00\x00\x02",
    "trailing_odd_header": lambda frames: struct.pack("<ii", 7, 4) + b"abcd",
    "trailing_negative": lambda frames: struct.pack("<ii", -1, 0),
    "trailing_garbage": lambda frames: struct.pack("<ii", 2, 1000) + b"\x01" * 30,
}


def _checkpoint_fields(ck):
    return (ck.kind, ck.block_index, ck.n_words, ck.total.tolist(), ck.fail.tolist(),
            ck.grand.tolist(), ck.epoch_words)


def _jax_checkpoint(path, impl):
    """The JAX package's checkpoint file as its tier for ``impl`` leaves
    it: the xla tier's (the twin of "torch"), and for the kernel impls
    that of the Pallas tiers, which count no fail stream for the QC-fail
    bit itself (jB.F_STREAMS), so their F[9] stays 0 (assemble_counters
    never reads it). The Pallas tiers run for minutes in interpret mode,
    hence xla's file with that entry set as theirs leave it."""
    ck = jS.StreamCheckpoint(path, EVERY)
    if impl != "torch":
        assert F.FQCFAIL_OFF not in jB.F_STREAMS
        ck.fail = ck.fail.copy()
        ck.fail[F.FQCFAIL_OFF] = 0
    return _checkpoint_fields(ck)


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("impl", list(IMPLS))
def test_bad_tail_raises_as_jax_and_leaves_its_checkpoint(tmp_path, monkeypatch, good, impl,
                                                          fault):
    path, x, frames = good
    monkeypatch.setattr(jD, "DEVICE_WORD_CAP", 150_000)   # epochs roll in flight
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 150_000)
    bad = _write(tmp_path / "bad.lz4", frames[:GOOD], FAULTS[fault](frames))
    with pytest.raises(ValueError) as want:
        list(jC.iter_framed(bad))             # the reader's own message
    with pytest.raises(ValueError) as jax_err:
        jS.flagstat_stream(bad, "lz4", impl="xla", chunk_words=GW, threads=1,
                           checkpoint=jS.StreamCheckpoint(tmp_path / "jax.npz", EVERY))
    with pytest.raises(ValueError) as port_err:
        L.flagstat_stream(bad, "lz4", impl=engage(impl, monkeypatch), chunk_words=GW,
                          threads=1,
                          checkpoint=S.StreamCheckpoint(tmp_path / "port.npz", EVERY),
                          **IMPLS[impl])
    assert str(port_err.value) == str(jax_err.value) == str(want.value)
    ck = S.StreamCheckpoint(tmp_path / "port.npz", EVERY)
    assert _checkpoint_fields(ck) == _jax_checkpoint(tmp_path / "jax.npz", impl)
    assert ck.block_index == GOOD // EVERY * EVERY and ck.n_words == ck.block_index * GW
    # the interrupted run resumes on the whole file, exactly
    np.testing.assert_array_equal(
        L.flagstat_stream(path, "lz4", impl=engage(impl, monkeypatch), chunk_words=GW,
                          checkpoint=ck, **IMPLS[impl]), flagstat_numpy(x))


def _corrupt(codec, frames, i):
    """frames with frame i's payload made undecodable for ``codec``."""
    raw_len, payload = frames[i]
    if codec == "raw":      # a raw frame must hold raw_len bytes
        bad = (raw_len, payload[:-2])
    else:
        bad = (raw_len, b"\xff" * len(payload))
    return frames[:i] + [bad] + frames[i + 1:]


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("impl", list(IMPLS))
def test_corrupt_payload_raises_as_jax(tmp_path, monkeypatch, impl, codec):
    x = generate_flags(12 * GW, seed=1512, full_range=True)
    path = tmp_path / f"good.{codec}"
    jC.write_framed(path, x, codec=codec, level=CODECS[codec], block_bytes=2 * GW)
    bad = _write(tmp_path / f"bad.{codec}", _corrupt(codec, list(jC.iter_framed(path)), 9))
    with pytest.raises((ValueError, RuntimeError)) as jax_err:
        jS.flagstat_stream(bad, codec, impl="xla", chunk_words=GW, threads=1,
                           checkpoint=jS.StreamCheckpoint(tmp_path / "jax.npz", EVERY))
    with pytest.raises((ValueError, RuntimeError)) as port_err:
        L.flagstat_stream(bad, codec, impl=engage(impl, monkeypatch), chunk_words=GW,
                          threads=1,
                          checkpoint=S.StreamCheckpoint(tmp_path / "port.npz", EVERY),
                          **IMPLS[impl])
    assert type(port_err.value) is type(jax_err.value)
    assert str(port_err.value) == str(jax_err.value)
    ck = S.StreamCheckpoint(tmp_path / "port.npz", EVERY)
    assert _checkpoint_fields(ck) == _jax_checkpoint(tmp_path / "jax.npz", impl)
    assert ck.block_index == 8


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("impl", list(IMPLS))
def test_without_the_native_library(framed, monkeypatch, impl, codec):
    """The same loop, decoding frame by frame with decompress_block."""
    monkeypatch.setattr(native_lib, "load", lambda: None)
    for geometry in ("unaligned", "frame_above_chunk"):
        path, x, jax_native, _ = framed(codec, geometry)
        got, timer, _ = counted(monkeypatch, impl, codec, lambda impl, timer: L.flagstat_stream(
            path, codec, impl=impl, chunk_words=GW, timer=timer, **IMPLS[impl]))
        np.testing.assert_array_equal(got, flagstat_numpy(x))
        np.testing.assert_array_equal(got, jax_native)
        card = impl == "cuda_card" and codec == "lz4"
        assert timer.counts["decode"] == (card_runs(path, codec)[1] if card
                                          else GEOMETRIES[geometry][2])


def test_runs_never_cross_a_checkpoint_boundary(tmp_path):
    """With a checkpoint every 3 blocks, runs of up to five 12,345-word
    frames break at blocks 3, 6, 9, ...: each boundary is saved."""
    x = generate_flags(200_003, seed=1513, full_range=True)
    path = tmp_path / "ck.lz4"
    jC.write_framed(path, x, codec="lz4", level=1, block_bytes=2 * 12_345)
    src = S._FramedFile(path, "lz4")
    try:
        runs = list(src.runs(0, len(src.frames), GW, every=3))
        assert runs == [(0, 3), (3, 6), (6, 9), (9, 12), (12, 15), (15, 17)]
        assert list(src.runs(0, len(src.frames), GW)) == [(0, 5), (5, 10), (10, 15),
                                                           (15, 17)]
        assert src.error is None
    finally:
        src.close()
    saved = []

    class Ck(S.StreamCheckpoint):
        def maybe_save(self, block_index, *args, **kw):
            saved.append(block_index)
            super().maybe_save(block_index, *args, **kw)

    got = L.flagstat_stream(path, "lz4", impl="torch", chunk_words=GW,
                            checkpoint=Ck(tmp_path / "c.npz", every_blocks=3))
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    assert saved == [3, 6, 9, 12, 15]


@pytest.mark.parametrize("calls,threads", [(1, 8), (2, 8), (4, 8), (4, 3), (4, 1), (8, 8)])
def test_decode_calls_in_flight(framed, monkeypatch, calls, threads):
    """Any number of runs in decode at once, on any share of the decode
    threads, counts the same, in stream order."""
    monkeypatch.setattr(S, "DECODE_CALLS", calls)
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", EPOCH_CAP)
    path, x, jax_native, _ = framed("lz4", "epoch_roll")
    for impl in IMPLS:
        with monkeypatch.context() as m:
            got, timer, _ = counted(m, impl, "lz4", lambda impl, timer: L.flagstat_stream(
                path, "lz4", impl=impl, chunk_words=GW, threads=threads, timer=timer,
                **IMPLS[impl]))
        np.testing.assert_array_equal(got, jax_native)
        if impl == "cuda_card":
            runs, copies = card_runs(path, "lz4", threads)
            assert timer.counts["decode_wait"] == runs and timer.counts["decode"] == copies
        else:
            assert timer.counts["decode"] == timer.counts["dispatch"] == 7


#: (SMs, DECODE_WORDS, SEGMENT_BYTES) of the card path: the CPU's one
#: "SM" and the defaults; launches of 6 and 21 frames; a decode buffer of
#: three 20,000-word frames; a device buffer of the file's bytes refilled
#: from its start every few runs
CARD_SIZES = [(1, None, None), (2, None, None), (7, None, None), (1, 60_000, None),
              (3, None, 200_000), (2, 45_000, 150_000)]


@pytest.mark.parametrize("sms,decode_words,segment_bytes", CARD_SIZES)
def test_card_launches_take_whole_landed_frames(framed, monkeypatch, sms, decode_words,
                                                segment_bytes):
    """Each decode launch takes the frames landed since the last, in
    order: at least FRAMES_PER_SM an SM but at the end or when the next
    run would overflow the decode buffer, which no launch of more than
    one frame does; the counts are exact with the epoch rolling."""
    monkeypatch.setattr(S, "_sms", lambda dev: sms)
    if decode_words:
        monkeypatch.setattr(S, "DECODE_WORDS", decode_words)
    if segment_bytes:
        monkeypatch.setattr(S, "SEGMENT_BYTES", segment_bytes)
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", EPOCH_CAP)
    launches = []

    def decode_frames(comp, table, first, count, *args):
        launches.append((first, count, int(table[first + count - 1, 2] + table[
            first + count - 1, 3] - table[first, 2]) // 2))
        return real(comp, table, first, count, *args)

    real = S.decode_frames
    monkeypatch.setattr(S, "decode_frames", decode_frames)
    for geometry in ("unaligned", "epoch_roll"):
        path, x, jax_native, _ = framed("lz4", geometry)
        launches.clear()
        got, timer, decoded = counted(monkeypatch, "cuda_card", "lz4",
                                      lambda impl, timer: L.flagstat_stream(
                                          path, "lz4", impl=impl, chunk_words=GW, timer=timer,
                                          device="cpu"))
        np.testing.assert_array_equal(got, jax_native)
        frames = len(list(jC.iter_framed(path)))
        assert decoded == {"card_frames": frames, "host_frames": 0,
                           "launches": len(launches)}
        assert [f for f, _, _ in launches] == list(np.cumsum([0] + [c for _, c, _ in
                                                                    launches])[:-1])
        assert sum(c for _, c, _ in launches) == frames
        for _, count, words in launches[:-1]:
            assert count >= S.FRAMES_PER_SM * sms or (decode_words and words + 2 * GW >
                                                      decode_words) or segment_bytes
        for _, count, words in launches:
            assert count == 1 or words <= S.DECODE_WORDS


def test_card_path_is_chosen_by_codec_impl_and_device():
    """The card decodes an LZ4 file counted by "cuda" on a CUDA device,
    and nothing else."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert S._card_decodes(1, "cuda", cuda)
    for codec, impl, dev in ((0, "cuda", cuda), (2, "cuda", cuda), (1, "cuda_pre", cuda),
                             (1, "torch", cuda), (1, "cuda", cpu)):
        assert not S._card_decodes(codec, impl, dev), (codec, impl, dev)


@pytest.mark.parametrize("blocks", [(0, 17), (3, 11), (16, 17), (5, 5)])
def test_card_path_counts_a_block_range_as_the_host(framed, monkeypatch, blocks):
    """The framed-file leg of ``parallel.multihost`` (``framed_range_sums``)
    over a block range: the card path's (C[k], F[k]) are the host path's."""
    path, _, _, _ = framed("lz4", "unaligned")
    start, stop = blocks
    host = S.framed_range_sums(path, "lz4", start, stop, "cuda", device="cpu")
    before = dict(S.CARD_DECODE)
    card = S.framed_range_sums(path, "lz4", start, stop, engage("cuda_card", monkeypatch),
                               device="cpu")
    assert S.CARD_DECODE["card_frames"] - before["card_frames"] == stop - start
    for a, b in zip(card, host):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

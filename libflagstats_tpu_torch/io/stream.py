"""Streaming flagstat of a framed compressed file: host decode, device count.

The port of ``libflagstats_tpu.io.stream``. The device tiers map the
file read-only, index its frame headers up front and take it as runs of
whole frames: as many as fit in ``chunk_words``, or one frame when a
frame alone is larger. The native library decodes each run on a thread
pool straight from the mapping into a slot of a small ring of pinned
host buffers (``lfs_decode_stream``; up to DECODE_CALLS runs at once),
so each word is written once on the host; the slots are copied to the
device on a side CUDA stream and counted there, in stream order, while
the host decodes the next runs. For
``impl="cuda_pre"`` a run is decoded into a host staging buffer instead,
and a 2-thread stage bit-transposes it into packed plane tiles (24
rows, 20 in report mode) written straight into a pinned slot, so that
decode(i+2), transpose(i+1) and copy+count(i) overlap. Each run's
kernel adds its sums into one accumulator on the device in place
(``ops/staging.Tally``); only the final 32 counters come back, written
by the epilogue kernel into a pinned host buffer (reference
counterpart: the per-block accumulate loop,
benchmark/flagstats.cpp:311-332). The
framed-file leg of ``parallel.multihost`` counts its block range through
the same loop (``framed_range_sums``).

Impls, against the JAX package's: ``native`` = ``native`` (host AVX2
counting, no device), ``cuda`` = ``pallas`` (the raw-word kernel per
run), ``cuda_pre`` = ``pallas_pre`` (host packed transpose, then the
plane-tile kernel) and ``torch`` = ``xla`` (plain torch).

What changes in torch: JAX took pageable numpy with ``jnp.asarray`` and
returned before the device finished. In torch a copy from pageable
memory blocks the host, so runs are decoded into pinned host buffers
(see ``ops/staging._Ring``), copied with ``non_blocking=True`` on a side CUDA
stream, and the compute stream waits on the copy's event. Without the
native library (on the CPU only) the same loop decodes frame by frame
with ``codec.decompress_block``. A bad header stops the stream where
the JAX package's does, with its message, after the frames before it
are counted and checkpointed.
"""
from __future__ import annotations

import concurrent.futures as cf
import ctypes
import mmap
import os
import struct
import zipfile
from collections import deque

import numpy as np
import torch

from .. import flags as F
from ..bench import profiling
from ..bench.profiling import SectionTimer
from ..config import CONFIG
from ..ops import dispatch as D
from ..ops import kernels as K
from ..ops import native_host
from ..ops.bitslice import pretranspose_host_packed
from ..ops.staging import Tally, _Ring
from . import codec as C
from . import native_lib

#: the impls that count on a device (``"native"`` counts on the host)
DEVICE_IMPLS = ("torch", "cuda", "cuda_pre")
#: runs that decode at once, each on its share of the decode threads: a
#: call's threads idle at its tail while another call's run (one call at
#: a time took 1.33-1.35x the wall of four in chip_smoke's phase 4e on an
#: H100's host; PERF.md §6)
DECODE_CALLS = 4
#: runs in the transpose stage at once (``cuda_pre``)
PRE_WINDOW = 2


def _decoded_blocks(path, codec, n_threads, start_block, timer):
    """Decode framed blocks on a thread pool with a bounded decode-ahead
    window (up to 4*n_threads blocks in flight, so memory stays
    O(window), not O(file)); yields uint16 views in stream order."""
    window = 4 * n_threads
    frames = C.iter_framed(path)
    for _ in range(start_block):
        next(frames, None)
    with cf.ThreadPoolExecutor(n_threads) as pool:
        futs: deque = deque()
        for raw_len, payload in frames:
            futs.append(pool.submit(C.decompress_block, payload, raw_len, codec))
            if len(futs) >= window:
                with timer.section("decode_wait"):
                    buf = futs.popleft().result()
                yield np.frombuffer(buf, dtype=np.uint16)
        while futs:
            with timer.section("decode_wait"):
                buf = futs.popleft().result()
            yield np.frombuffer(buf, dtype=np.uint16)


def _flagstat_stream_native(path, codec, threads, checkpoint, timer):
    """Host-native streaming tier: decode-ahead pool + the AVX2 kernel
    accumulating straight into one uint64[32] vector (the reference's
    per-block accumulate loop, benchmark/flagstats.cpp:311-332, with
    the decode parallelized). No int32 staging exists here, so the
    device paths' DEVICE_WORD_CAP does not apply."""
    n_threads = threads or CONFIG.decode_threads or 8
    if timer is None:
        timer = SectionTimer()

    if checkpoint is None:
        # no block-boundary state to persist -> the fully fused C++
        # pipeline (mmap -> per-block decode+count in native workers)
        with timer.section("decode_count"):
            counters, _ = native_host.flagstat_framed_native(
                path, C._codec_id(codec), threads=n_threads)
        return counters

    counters = np.zeros(F.N_COUNTERS, dtype=np.uint64)
    n_words = 0
    block_index = 0
    if checkpoint.block_index > 0:
        if checkpoint.kind != "counters":
            raise ValueError(
                "checkpoint was written by a device-path run (partial "
                "stream sums); it cannot resume the native host path")
        counters[:16] = checkpoint.total
        counters[16:] = checkpoint.fail
        n_words = checkpoint.n_words
        block_index = checkpoint.block_index

    for block in _decoded_blocks(path, codec, n_threads, block_index, timer):
        n_words += block.size
        # threads=1: one framed block is a single slab for the kernel
        # anyway, and the decode pool owns the cores
        with timer.section("count"):
            native_host.flagstat_native(block, out=counters, threads=1)
        block_index += 1
        with timer.section("checkpoint"):
            checkpoint.maybe_save(block_index, counters[:16],
                                  counters[16:], n_words, kind="counters")
    return counters


def _count_device(impl: str, device) -> torch.device:
    """Where a device impl counts: ``device`` if given; else the CUDA
    device, or for ``"torch"`` the CPU when there is none. Raises when
    that is a CUDA device and none is available: no fallback."""
    if device is None:
        device = "cuda" if impl != "torch" or torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"impl {impl!r} was asked to count on {device}, "
                           "and no CUDA device is available")
    return device


def _host_i32(t: torch.Tensor) -> np.ndarray:
    """Device sums as the int32 the checkpoint file holds (the epoch roll
    keeps every sum within int32, so the JAX package can resume it)."""
    return t.cpu().numpy().astype(np.int32)


#: count one shipped chunk into the stream's tally, enqueued on the
#: chunk's device: the count of the device stream. A module-level name, so
#: that a measurement can wrap it (tools/pipeline_balance.py synchronises
#: after it to forbid any overlap)
_chunk_sums = Tally.add


def _index_frames(buf, size: int) -> tuple[list[tuple[int, int, int]], str | None]:
    """(payload offset, raw_len, comp_len) of each frame of the framed
    stream in ``buf``, by the rules ``codec.iter_framed`` and
    ``codec.scan_frames`` share, up to the first bad header; and the
    message ``iter_framed`` raises there (None when the walk reached the
    end of the stream)."""
    frames = []
    off = 0
    while off < size:
        if off + 8 > size:
            return frames, "truncated frame header"
        raw_len, comp_len = struct.unpack_from("<ii", buf, off)
        if raw_len < 0 or comp_len < 0:
            return frames, "corrupt frame header (negative length)"
        if raw_len % 2:
            return frames, "corrupt frame header (odd raw length)"
        if off + 8 + comp_len > size:
            return frames, "truncated frame payload"
        frames.append((off + 8, raw_len, comp_len))
        off += 8 + comp_len
    return frames, None


class _FramedFile:
    """A framed stream file mapped read-only, with its frame index
    (``frames``, and ``error``: what stopped the walk). Decodes runs of
    whole frames straight from the mapping into a caller's buffer."""

    def __init__(self, path, codec):
        self.codec = C._codec_id(codec)
        if self.codec not in (C.CODEC_RAW, C.CODEC_LZ4, C.CODEC_ZSTD):
            raise ValueError(f"unknown codec {codec}")
        with open(path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            self.mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) if size else None
        self.frames, self.error = _index_frames(self.mm, size)
        # the mapping's address; the array holds the buffer export until close()
        self._bytes = np.frombuffer(self.mm, dtype=np.uint8) if size else None
        self.addr = self._bytes.ctypes.data if size else 0

    def advise(self, start: int, stop: int) -> None:
        """Have the kernel read frames [start, stop) ahead, as
        ops/native_host.flagstat_framed_native does: demand paging of a
        cold file faults one page at a time."""
        if start >= stop or not hasattr(self.mm, "madvise"):
            return
        lo = (self.frames[start][0] - 8) // mmap.PAGESIZE * mmap.PAGESIZE
        hi = self.frames[stop - 1][0] + self.frames[stop - 1][2]
        self.mm.madvise(mmap.MADV_SEQUENTIAL)
        self.mm.madvise(mmap.MADV_WILLNEED, lo, hi - lo)

    def runs(self, start: int, stop: int, chunk_words: int, every: int = 0):
        """Runs [a, b) of whole frames over [start, stop): as many as fit
        in ``chunk_words`` words, or one frame when it alone is larger.
        No run crosses a block index that is a multiple of ``every``
        (when nonzero), so a checkpoint can be saved after any run that
        ends on one."""
        a = start
        while a < stop:
            b, words = a + 1, self.frames[a][1] // 2
            while (b < stop and words + self.frames[b][1] // 2 <= chunk_words
                   and not (every and b % every == 0)):
                words += self.frames[b][1] // 2
                b += 1
            yield a, b
            a = b

    def decode(self, a: int, b: int, out: np.ndarray, n_threads: int) -> int:
        """Decode frames [a, b) into the start of ``out`` (uint16) -> the
        words written. With the native library one ``lfs_decode_stream``
        call decodes the run on ``n_threads`` threads from the mapping;
        without it, frame by frame with ``codec.decompress_block``. A
        failed decode raises what ``decompress_block`` raises for the
        frame at fault."""
        frames = self.frames[a:b]
        raw = sum(r for _, r, _ in frames)
        lib = native_lib.load()
        if lib is None:
            pos = 0
            for off, raw_len, comp_len in frames:
                block = C.decompress_block(self.mm[off:off + comp_len], raw_len, self.codec)
                out[pos:pos + raw_len // 2] = np.frombuffer(block, dtype=np.uint16)
                pos += raw_len // 2
            return pos
        lo = frames[0][0] - 8
        hi = frames[-1][0] + frames[-1][2]
        # the binding's stream argument is c_char_p: pass the mapping's
        # address as one, so ctypes copies nothing
        r = lib.lfs_decode_stream(ctypes.cast(self.addr + lo, ctypes.c_char_p), hi - lo,
                                  out.ctypes.data, out.nbytes, self.codec, n_threads)
        if r != raw:
            for off, raw_len, comp_len in frames:
                C.decompress_block(self.mm[off:off + comp_len], raw_len, self.codec)
            raise RuntimeError("framed stream decode failed")
        return raw // 2

    def close(self) -> None:
        self._bytes = None   # release the buffer export before the mapping closes
        if self.mm is not None:
            self.mm.close()


class _Sums:
    """The device stream's count at a block boundary: the epoch's sums in
    a ``Tally`` on the device, the host uint64 grand total of the epochs
    rolled before it, the epoch's and the stream's words, and the next
    block. Starts from a ``"sums"`` checkpoint when one is given."""

    def __init__(self, dev: torch.device, impl: str, report: bool = False, checkpoint=None):
        self.tally = Tally(impl, dev, report)
        self.grand = np.zeros(F.N_COUNTERS, dtype=np.uint64)
        self.epoch_words = self.n_words = self.block = 0
        if checkpoint is not None and checkpoint.block_index > 0:
            if checkpoint.kind != "sums":
                raise ValueError(
                    "checkpoint was written by the native host path (final "
                    "counters); it cannot resume a device-path run")
            self.tally.seed(checkpoint.total, checkpoint.fail)
            self.grand = checkpoint.grand.astype(np.uint64)
            self.epoch_words = checkpoint.epoch_words
            self.n_words = checkpoint.n_words
            self.block = checkpoint.block_index

    def roll(self) -> None:
        """Add the epoch's counters into the grand total and start the
        device sums again: every sum and the derived pass total stay
        within int32, so a checkpoint holds what the JAX package can
        resume (the block-accumulative contract makes the split exact;
        reference: flagstats.cpp:311-332)."""
        self.grand += self.tally.counters(self.epoch_words)
        self.tally.clear()
        self.epoch_words = 0

    def counters(self, timer=None) -> np.ndarray:
        """The stream's 32 counters (uint64); waits for the device (span
        ``lfs.readback``, ``timer``'s section ``final_sync``)."""
        return self.grand + self.tally.counters(self.epoch_words, timer)


def _count_frames(src: _FramedFile, sums: _Sums, stop: int, impl: str, chunk_words: int,
                  report: bool, n_threads: int, timer, checkpoint=None,
                  cap: int | None = None) -> None:
    """Count frames [sums.block, stop) of ``src`` into ``sums``, on the
    device of ``sums``: each run of whole frames is decoded straight into
    a ring slot (``cuda_pre``: into a host staging buffer, then
    transposed into one), shipped and counted by ``_chunk_sums``, in
    stream order. Up to DECODE_CALLS runs decode at once, each on its
    share of the ``n_threads`` decode threads. Saves ``checkpoint`` after
    each run that ends on its block interval, with nothing of the runs
    before it in flight; rolls the epoch before a run that would take it
    past ``cap`` words."""
    pre = impl == "cuda_pre"
    start = sums.block
    every = checkpoint.every_blocks if checkpoint is not None else 0
    calls = min(DECODE_CALLS, n_threads)
    slot_words = max(chunk_words, max((r // 2 for _, r, _ in src.frames[start:stop]),
                                      default=0))
    # slots: one per run in decode (or in the transpose stage), one being
    # copied and counted, and a spare, so that taking one seldom waits
    depth = max(calls, PRE_WINDOW) + 2
    src.advise(start, stop)
    if pre:
        rows = K.packed_rows_for(report)
        groups = -(-slot_words // K.GROUP_WORDS)
        ring = _Ring((groups, len(rows), K.SUB, K.LANE), torch.int32, sums.tally.device,
                     depth)
        # one per run in decode or in the transpose stage, and a spare
        stage = [np.empty(groups * K.GROUP_WORDS, dtype=np.uint16)
                 for _ in range(calls + PRE_WINDOW + 1)]
        xpool = cf.ThreadPoolExecutor(2, thread_name_prefix="pretrans")
    else:
        ring = _Ring((slot_words,), torch.int16, sums.tally.device, depth)
        xpool = None
    dpool = cf.ThreadPoolExecutor(calls, thread_name_prefix="decode")
    decoding: deque = deque()
    pending: deque = deque()
    # the workers' spans record under the call's, when it records
    call = profiling.current()

    def decode(a, b, out):
        took = SectionTimer()
        with profiling.span("lfs.stream.decode", took, under=call, first_frame=a,
                            frames=b - a) as s:
            words = src.decode(a, b, out, n_threads // calls)
            s.note(words=words)
        return words, took.totals["decode"]

    def transpose(buf, slot, g):
        with profiling.span("lfs.stage.transpose", under=call, bytes=buf.nbytes):
            pretranspose_host_packed(buf, rows, 2, ring.host_np[slot][:g])

    def dispatch(slot, size, words):
        if cap is not None and sums.epoch_words + words > cap:
            sums.roll()
        # ship times the enqueue of the copy, not the copy: slot_wait and
        # final_sync show where the host waits for the device
        chunk = ring.ship(slot, size, timer)
        with profiling.span("lfs.stream.dispatch", timer):
            _chunk_sums(sums.tally, chunk)
            ring.release(slot)
        sums.epoch_words += words

    def drain(keep: int = 0):
        """Count transposed runs until at most ``keep`` remain in the
        transpose stage."""
        while len(pending) > keep:
            fut, slot, size, words = pending.popleft()
            with profiling.span("lfs.stream.transpose_wait", timer):
                fut.result()
            dispatch(slot, size, words)

    def finish():
        """Take the oldest run in decode on to the count (a failed decode
        raises here, after every run before it is counted)."""
        fut, b, slot, buf = decoding.popleft()
        with profiling.span("lfs.stream.decode_wait", timer):
            words, seconds = fut.result()
        timer.add("decode", seconds)
        if pre:
            g = -(-words // K.GROUP_WORDS)
            buf[words:g * K.GROUP_WORDS] = 0   # the tail pads with zero words
            if g:
                slot = ring.acquire(timer)
                pending.append((xpool.submit(transpose, buf[:g * K.GROUP_WORDS], slot, g),
                                slot, g, words))
                drain(keep=PRE_WINDOW)
        elif words:
            dispatch(slot, words, words)
        sums.n_words += words
        sums.block = b
        if every and b % every == 0:
            drain()
            with profiling.span("lfs.stream.checkpoint", timer):
                total, fail = sums.tally.streams()
                checkpoint.maybe_save(b, _host_i32(total), _host_i32(fail),
                                      sums.n_words, grand=sums.grand,
                                      epoch_words=sums.epoch_words)

    try:
        for k, (a, b) in enumerate(src.runs(start, stop, chunk_words, every)):
            if pre:
                slot, buf = None, stage[k % len(stage)]
            else:
                slot = ring.acquire(timer)
                buf = ring.host_np[slot]
            decoding.append((dpool.submit(decode, a, b, buf), b, slot, buf))
            if len(decoding) == calls:
                finish()
        while decoding:
            finish()
        drain()
    finally:
        # the decodes still in flight read the mapping and write the slots
        dpool.shutdown(cancel_futures=True)
        if xpool is not None:
            xpool.shutdown()
        ring.close()


def _device_args(impl: str, chunk_words: int | None, device) -> tuple[int, torch.device]:
    """(chunk_words, device) of a device impl's stream, checked; raises
    before anything is read."""
    if impl not in DEVICE_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected 'native' or one of "
                         f"{DEVICE_IMPLS}")
    if chunk_words is None:
        chunk_words = CONFIG.stream_chunk_words
    if chunk_words <= 0:
        raise ValueError(f"chunk_words must be positive, got {chunk_words}")
    if impl == "cuda_pre" and chunk_words % K.GROUP_WORDS:
        raise ValueError(f"cuda_pre chunk_words must be a multiple of "
                         f"{K.GROUP_WORDS} (whole transpose groups)")
    dev = _count_device(impl, device)
    if dev.type == "cuda" and native_lib.load() is None:
        raise RuntimeError("the device stream decodes and transposes with the "
                           "native host library, which did not build: "
                           f"{native_lib.BUILD_ERROR}")
    return chunk_words, dev


def flagstat_stream(path, codec: str | int = "lz4", impl: str | None = None,
                    chunk_words: int | None = None, threads: int = 0,
                    checkpoint=None, report: bool = False, timer=None,
                    device=None) -> np.ndarray:
    """Framed stream -> 32-counter vector (uint64), decode and count
    overlapped.

    ``impl``: ``"native"``, ``"torch"``, ``"cuda"`` or ``"cuda_pre"``;
    None picks ``"torch"`` for ``device="cpu"``, else ``"cuda"`` (the
    JAX package's device default is ``"pallas"``), and raises when no
    CUDA device is present. The fused host stream, ``"native"``, is
    chosen by name. ``device``: where a device impl counts (default: the
    CUDA device; for ``"torch"`` the CPU when there is none). ``"cuda"``
    and ``"cuda_pre"`` on ``device="cpu"`` run the kernels' plain
    versions; on a CUDA device they launch the kernels, and the decode
    and transpose need the native library: the call raises if it did
    not build. ``chunk_words``: at most this many words per device run,
    in whole frames (default ``CONFIG.stream_chunk_words``; a frame
    larger than it goes alone; ``"cuda_pre"`` takes a multiple of
    65,536, whole transpose groups). ``threads``: decode threads
    (default ``CONFIG.decode_threads``, else 8). ``report=True`` counts
    the 21 report streams on the kernel impls; ``"torch"`` counts all 32
    counters either way. ``checkpoint``: a StreamCheckpoint to resume
    from and update at its block interval. ``timer``: a SectionTimer
    that accumulates the pipeline's stages (decode: the walls of the
    decode calls, summed, though up to DECODE_CALLS of them overlap;
    decode_wait: the calling thread's wait for the oldest decode;
    slot_wait, transpose_wait, ship: the enqueue of a slot's copy, not
    the copy; dispatch, checkpoint, final_sync; the native impl's
    decode_count, or with a checkpoint decode_wait and count). The same
    sites are the spans ``lfs.stream.*`` and ``lfs.stage.*`` under the
    call's ``lfs.flagstat_stream`` (``bench/profiling.py``).

    A bad frame header, a truncated payload or trailing bytes raise the
    ``ValueError`` of ``codec.iter_framed`` after the frames before them
    are counted and checkpointed; a failed decode raises what
    ``codec.decompress_block`` raises. The device sums are int64, but
    streams past ops.dispatch's DEVICE_WORD_CAP still roll each epoch
    into a host uint64 grand total, so a ``"sums"`` checkpoint holds
    int32-range values the JAX package can resume (and vice versa)."""
    if impl is None:
        impl = D.device_impl(device)
    with profiling.span("lfs.flagstat_stream", impl=impl) as call:
        if impl == "native":
            return _flagstat_stream_native(path, codec, threads, checkpoint, timer)
        chunk_words, dev = _device_args(impl, chunk_words, device)
        if timer is None:
            timer = SectionTimer()
        src = _FramedFile(path, codec)
        try:
            call.note(frames=len(src.frames))
            report = report and impl != "torch"
            sums = _Sums(dev, impl, report, checkpoint)
            _count_frames(src, sums, len(src.frames), impl, chunk_words, report,
                          threads or CONFIG.decode_threads or 8, timer, checkpoint,
                          D.DEVICE_WORD_CAP)
            if src.error is not None:
                raise ValueError(src.error)
            return sums.counters(timer)
        finally:
            src.close()


def framed_range_sums(path, codec: str | int, start: int, stop: int, impl: str,
                      threads: int = 0, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(C[k], F[k]) int64 sums of blocks [start, stop) of a framed file,
    on the device a device impl counts on: the framed-file leg of
    ``parallel.multihost``, through the stream's loop at
    ``CONFIG.stream_chunk_words``. No epoch rolls (the sums are int64);
    the caller derives counter 9 from the word count. Raises as
    ``flagstat_stream`` does."""
    chunk_words, dev = _device_args(impl, None, device)
    src = _FramedFile(path, codec)
    try:
        if not 0 <= start <= stop:
            raise ValueError(f"bad block range [{start}, {stop})")
        sums = _Sums(dev, impl)
        sums.block = start
        _count_frames(src, sums, min(stop, len(src.frames)), impl, chunk_words, False,
                      threads or CONFIG.decode_threads or 8, SectionTimer())
        if stop > len(src.frames):
            raise ValueError(src.error or f"block range [{start}, {stop}) outside "
                             f"{len(src.frames)}-block stream")
        return sums.tally.streams()
    finally:
        src.close()


class StreamCheckpoint:
    """Persist (block_index, partial stream sums) so an interrupted run
    resumes without recounting. The ``.npz`` fields and kinds are the
    JAX package's: either package resumes the other's file."""

    def __init__(self, path, every_blocks: int = 64):
        self.path = str(path)
        self.every_blocks = every_blocks
        self.block_index = 0
        self.n_words = 0
        self.kind = "sums"   # "sums" (device paths) | "counters" (native)
        self.total = np.zeros(F.N_BITS, np.int32)
        self.fail = np.zeros(F.N_BITS, np.int32)
        # device-path epoch state (streams past DEVICE_WORD_CAP roll
        # assembled epochs into the uint64 grand total)
        self.grand = np.zeros(F.N_COUNTERS, np.uint64)
        self.epoch_words = 0
        self._load()

    def _load(self):
        try:
            with np.load(self.path) as z:
                self.block_index = int(z["block_index"])
                self.n_words = int(z["n_words"])
                self.total = z["total"]
                self.fail = z["fail"]
                # files without a kind field hold device-path stream sums
                self.kind = str(z["kind"]) if "kind" in z else "sums"
                # files without epoch state were one epoch
                self.grand = (z["grand"].astype(np.uint64) if "grand" in z
                              else np.zeros(F.N_COUNTERS, np.uint64))
                self.epoch_words = (int(z["epoch_words"])
                                    if "epoch_words" in z else self.n_words)
        except (OSError, KeyError, ValueError, EOFError,
                zipfile.BadZipFile):
            # a missing file, or one truncated by a crash mid-save: both
            # mean "start from zero", never a crash on resume
            pass

    def maybe_save(self, block_index, total, fail, n_words, force=False,
                   kind: str = "sums", grand=None, epoch_words=None):
        if not force and block_index % self.every_blocks:
            return
        self.block_index = block_index
        self.n_words = n_words
        self.kind = kind
        self.total = np.asarray(total)
        self.fail = np.asarray(fail)
        self.grand = (np.asarray(grand, dtype=np.uint64) if grand is not None
                      else np.zeros(F.N_COUNTERS, np.uint64))
        self.epoch_words = n_words if epoch_words is None else epoch_words
        # write through a file handle (np.savez appends '.npz' to bare
        # paths) and publish atomically: a crash mid-save leaves the
        # previous checkpoint intact
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, block_index=block_index, n_words=n_words,
                     total=self.total, fail=self.fail, kind=kind,
                     grand=self.grand, epoch_words=self.epoch_words)
        os.replace(tmp, self.path)

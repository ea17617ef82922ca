"""Streaming flagstat of a framed compressed file: host decode, device count.

The port of ``libflagstats_tpu.io.stream``. The host decodes framed
blocks on a thread pool ahead of the device; staged chunks of words go
to the device, and for ``impl="cuda_pre"`` first through a 2-thread
host stage that bit-transposes each chunk into packed plane tiles
(24 rows, 20 in report mode), so that decode(i+2), transpose(i+1) and
copy+count(i) overlap. Counters accumulate on the device as the
(C[k], F[k]) stream-sum pair; only the final 32-counter vector comes
back (reference counterpart: the per-block accumulate loop,
benchmark/flagstats.cpp:311-332).

Impls, against the JAX package's: ``native`` = ``native`` (host AVX2
counting, no device), ``cuda`` = ``pallas`` (the raw-word kernel per
chunk), ``cuda_pre`` = ``pallas_pre`` (host packed transpose, then the
plane-tile kernel) and ``torch`` = ``xla`` (plain torch).

What changes in torch: JAX took pageable numpy with ``jnp.asarray`` and
returned before the device finished. In torch a copy from pageable
memory blocks the host, so chunks are written into a small ring of
pinned host buffers (the transpose stage writes its tiles straight into
one), copied with ``non_blocking=True`` on a side CUDA stream, and the
compute stream waits on the copy's event (see ``_Ring``).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import zipfile
from collections import deque

import numpy as np
import torch

from .. import flags as F
from ..bench.profiling import SectionTimer
from ..config import CONFIG
from ..ops import dispatch as D
from ..ops import kernels as K
from ..ops import native_host
from ..ops.bitslice import pretranspose_host_packed
from ..ops.torch_ops import assemble_counters, stream_sums_from_numpy, stream_sums_torch
from . import codec as C
from . import native_lib

#: the impls that count on a device (``"native"`` counts on the host)
DEVICE_IMPLS = ("torch", "cuda", "cuda_pre")
#: pinned host slots: 2 in the transpose stage, 1 being filled, 1 copying
RING_DEPTH = 4


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


class _Ring:
    """Host staging slots of the device stream: pinned, each with a
    device twin, when the count runs on a CUDA device; plain host memory,
    counted in place, on the CPU.

    The hazards it guards: a slot is refilled only after the
    host->device copy that read it has completed (``acquire``), and a
    copy overwrites a slot's device twin only after the kernel that read
    it has completed (``ship`` waits on the event ``release`` records)."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        view = np.uint16 if dtype == torch.int16 else np.uint32
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                     for _ in range(RING_DEPTH)]
        self.host_np = [h.numpy().view(view) for h in self.host]
        self.dev = ([torch.empty(shape, dtype=dtype, device=device)
                     for _ in range(RING_DEPTH)] if self.cuda else self.host)
        self.copied = [None] * RING_DEPTH
        self.consumed = [None] * RING_DEPTH
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.next = 0

    def acquire(self) -> int:
        """The next slot, once the copy that last read it has completed."""
        slot = self.next
        self.next = (slot + 1) % RING_DEPTH
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        return slot

    def ship(self, slot: int, n: int) -> torch.Tensor:
        """The first ``n`` entries of ``slot`` where the count runs. On a
        CUDA device the copy runs on the side stream, and the current
        (compute) stream waits for it."""
        if not self.cuda:
            return self.host[slot][:n]
        dst = self.dev[slot][:n]
        with torch.cuda.stream(self.copy_stream):
            if self.consumed[slot] is not None:
                self.copy_stream.wait_event(self.consumed[slot])
            dst.copy_(self.host[slot][:n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self.copied[slot] = done
        torch.cuda.current_stream(self.device).wait_event(done)
        return dst

    def release(self, slot: int) -> None:
        """Mark the work enqueued so far on the compute stream as the
        last reader of ``slot``'s device twin."""
        if self.cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self.consumed[slot] = done

    def close(self) -> None:
        """Wait for every copy and count that may read the slots."""
        if self.cuda:
            self.copy_stream.synchronize()
            torch.cuda.current_stream(self.device).synchronize()


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


def _chunk_sums(impl: str, chunk: torch.Tensor, report: bool):
    """(C[k], F[k]) of one shipped chunk, enqueued on the chunk's device:
    the count of the device stream. Module-level so that a measurement
    can wrap it (tools/pipeline_balance.py synchronises after it to
    forbid any overlap)."""
    if impl == "torch":
        return stream_sums_torch(chunk)
    if impl == "cuda_pre":
        sums = K.stream_sums_pre_cuda(chunk, report, packed=True)
    else:
        sums = K.stream_sums_cuda(chunk, "flagstat_report" if report else "flagstat")
    return K._sums_to_streams(sums, report)


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
    chosen by name: on the H100's host it is the faster one (PERF.md).
    ``device``: where a device impl counts (default: the CUDA device;
    for ``"torch"`` the CPU when there is none). ``"cuda"`` and
    ``"cuda_pre"`` on ``device="cpu"`` run the kernels' plain versions;
    on a CUDA device they launch the kernels, and the decode and
    transpose need the native library: the call raises if it did not
    build. ``chunk_words``: words per device chunk (default
    ``CONFIG.stream_chunk_words``; ``"cuda_pre"`` takes whole 65,536-word
    groups). ``report=True`` counts the 21 report streams on the kernel
    impls; ``"torch"`` counts all 32 counters either way.
    ``checkpoint``: a StreamCheckpoint to resume from and update at its
    block interval. ``timer``: a SectionTimer that accumulates the
    pipeline's stages (decode_wait, chunk_copy, slot_wait,
    transpose_wait, h2d, dispatch, checkpoint, final_sync).

    The device sums are int64, but streams past ops.dispatch's
    DEVICE_WORD_CAP still roll each epoch into a host uint64 grand total,
    so a ``"sums"`` checkpoint holds int32-range values the JAX package
    can resume (and vice versa)."""
    if impl is None:
        impl = D.device_impl(device)
    if impl == "native":
        return _flagstat_stream_native(path, codec, threads, checkpoint, timer)
    if impl not in DEVICE_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected 'native' or one of "
                         f"{DEVICE_IMPLS}")
    if chunk_words is None:
        chunk_words = CONFIG.stream_chunk_words
    pre = impl == "cuda_pre"
    if chunk_words <= 0:
        raise ValueError(f"chunk_words must be positive, got {chunk_words}")
    if pre and chunk_words % K.GROUP_WORDS:
        raise ValueError(f"cuda_pre chunk_words must be a multiple of "
                         f"{K.GROUP_WORDS} (whole transpose groups)")
    dev = _count_device(impl, device)
    if dev.type == "cuda" and native_lib.load() is None:
        raise RuntimeError("the device stream decodes and transposes with the "
                           "native host library, which did not build: "
                           f"{native_lib.BUILD_ERROR}")
    report = report and impl != "torch"

    total = torch.zeros(F.N_BITS, dtype=torch.int64, device=dev)
    fail = torch.zeros_like(total)
    grand = np.zeros(F.N_COUNTERS, dtype=np.uint64)
    epoch_words = 0
    n_words = 0
    start_block = 0
    if checkpoint is not None and checkpoint.block_index > 0:
        if checkpoint.kind != "sums":
            raise ValueError(
                "checkpoint was written by the native host path (final "
                "counters); it cannot resume a device-path run")
        total, fail = stream_sums_from_numpy(checkpoint.total, checkpoint.fail, dev)
        grand = checkpoint.grand.astype(np.uint64)
        epoch_words = checkpoint.epoch_words
        n_words = checkpoint.n_words
        start_block = checkpoint.block_index

    n_threads = threads or CONFIG.decode_threads or 8
    if timer is None:
        timer = SectionTimer()
    rows = K.packed_rows_for(report) if pre else None
    if pre:
        ring = _Ring((chunk_words // K.GROUP_WORDS, len(rows), K.SUB, K.LANE),
                     torch.int32, dev)
    else:
        ring = _Ring((chunk_words,), torch.int16, dev)

    def roll_epoch():
        # assemble the epoch's counters into the host grand total and
        # reset the device sums: every sum and the derived pass total
        # stay within int32 (the block-accumulative contract makes the
        # split exact; reference: flagstats.cpp:311-332)
        nonlocal total, fail, epoch_words
        counters = assemble_counters(total, fail, epoch_words)
        grand[:] += counters.cpu().numpy().astype(np.uint64)
        total = torch.zeros_like(total)
        fail = torch.zeros_like(fail)
        epoch_words = 0

    def dispatch_chunk(slot, size, words):
        nonlocal total, fail, epoch_words
        if epoch_words + words > D.DEVICE_WORD_CAP:
            roll_epoch()
        # h2d times the enqueue of the copy, not the copy: slot_wait and
        # final_sync show where the host waits for the device
        with timer.section("h2d"):
            chunk = ring.ship(slot, size)
        with timer.section("dispatch"):
            c, f = _chunk_sums(impl, chunk, report)
            total += c
            fail += f
            ring.release(slot)
        epoch_words += words

    xpool = cf.ThreadPoolExecutor(2, thread_name_prefix="pretrans") if pre else None
    pending: deque = deque()

    def drain_pending(keep: int = 0):
        """Count transposed chunks until at most ``keep`` remain in the
        in-flight window."""
        while len(pending) > keep:
            fut, slot, size, words = pending.popleft()
            with timer.section("transpose_wait"):
                fut.result()
            dispatch_chunk(slot, size, words)

    def emit_chunk(view, words):
        """Route one staged chunk (a view of the staging buffer, copied
        before this returns) to the device: through a slot, or via the
        transpose stage with a 2-deep in-flight window."""
        if not pre:
            with timer.section("slot_wait"):
                slot = ring.acquire()
            with timer.section("chunk_copy"):
                ring.host_np[slot][:view.size] = view
            dispatch_chunk(slot, view.size, words)
            return
        with timer.section("chunk_copy"):
            chunk = np.array(view)
        groups = -(-view.size // K.GROUP_WORDS)   # the tail pads with zero words
        with timer.section("slot_wait"):
            slot = ring.acquire()
        pending.append((xpool.submit(pretranspose_host_packed, chunk, rows, 2,
                                     ring.host_np[slot][:groups]),
                        slot, groups, words))
        drain_pending(keep=2)

    block_index = start_block
    buf = np.empty(2 * chunk_words, dtype=np.uint16)
    fill = 0
    try:
        for block in _decoded_blocks(path, codec, n_threads, start_block, timer):
            n_words += block.size
            off = 0
            while off < block.size:
                take = min(block.size - off, 2 * chunk_words - fill)
                with timer.section("chunk_copy"):
                    buf[fill:fill + take] = block[off:off + take]
                fill += take
                off += take
                while fill >= chunk_words:
                    emit_chunk(buf[:chunk_words], chunk_words)
                    rem = fill - chunk_words
                    if rem:
                        with timer.section("chunk_copy"):
                            buf[:rem] = buf[chunk_words:fill]
                    fill = rem
            block_index += 1
            # a checkpoint is valid only when no words wait in the staging
            # buffer or the transpose stage (they are in n_words but not
            # yet in the sums): when a save is due, drain the window first
            if (checkpoint is not None and fill == 0
                    and block_index % checkpoint.every_blocks == 0):
                drain_pending()
                with timer.section("checkpoint"):
                    checkpoint.maybe_save(block_index, _host_i32(total),
                                          _host_i32(fail), n_words, grand=grand,
                                          epoch_words=epoch_words)
        if fill:
            emit_chunk(buf[:fill], fill)
        drain_pending()
        with timer.section("final_sync"):
            counters = assemble_counters(total, fail, epoch_words).cpu().numpy()
    finally:
        if xpool is not None:
            xpool.shutdown()
        ring.close()
    return grand + counters.astype(np.uint64)


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

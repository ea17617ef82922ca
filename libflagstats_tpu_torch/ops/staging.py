"""Host->device staging: a host column counted on a device in pinned pieces.

A copy from pageable host memory blocks the host and runs at the rate
of one ``memcpy`` into the CUDA runtime's own staging buffer (~7-8 GB/s on an
H100's host, PERF.md). Every kernel tier that takes a host column
stages it here instead: the one-shot entry points (``ops/dispatch.py``
``flagstats_u16`` and ``pospopcnt_u16``), the sharded count
(``parallel/sharded.py``, and through it ``flagstat_multihost``), and
the device stream (``io/stream.py``, whose decode writes straight into
the ring's slots).

``staged_sums`` counts host columns in pieces of STAGE_WORDS words.
Piece i is copied on the host's threads into a pinned slot of the
device's ring (``cuda_pre``: bit-transposed into packed plane tiles
there), shipped on the ring's side stream, counted on the compute
stream, and its int64 sums are added into device accumulators; the host
fills the next slot with piece i+1 meanwhile. Each device has one ring,
made at the first call that needs it and kept for the process (``ring``).
On the CPU the slots are plain host memory and each piece is counted in
place by the kernels' plain versions, through the same loop.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..bench import profiling
from . import kernels as K
from .bitslice import pretranspose_host_packed
from .torch_ops import stream_sums_torch
from .words_kernels import stream_sums_words_cuda

#: words a piece of a host column holds, and a ring slot's capacity: a
#: multiple of K.GROUP_WORDS, so a ``cuda_pre`` piece is whole transpose
#: groups (its packed tiles take 1.5 or 1.25 bytes a word of the slot's
#: 2). 16Mi: the best of 1Mi, 4Mi and 16Mi on an H100's host (PERF.md)
STAGE_WORDS = 1 << 24
#: slots of a ring: pieces in flight on one device
DEPTH = 4
#: threads of a ``cuda_pre`` piece's packed transpose: the best of 2, 4
#: and 8 on an H100's 8-core host (PERF.md)
TRANSPOSE_THREADS = 4
#: host columns staged, and pieces shipped (counted where a piece is
#: shipped and nowhere else)
STAGED = {"columns": 0, "pieces": 0}

_RINGS: dict = {}
#: one staged call at a time: the rings are shared by every caller
_LOCK = threading.Lock()


class _Ring:
    """Host staging slots of the device stream: pinned, each with a
    device twin, when the count runs on a CUDA device; plain host memory,
    counted in place, on the CPU.

    The hazards it guards: a slot is refilled only after the
    host->device copy that read it has completed (``acquire``), and a
    copy overwrites a slot's device twin only after the kernel that read
    it has completed (``ship`` waits on the event ``release`` records).
    A slot whose run is still in decode is the caller's to guard: it
    keeps fewer runs in decode than the ring has slots."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device, depth: int):
        self.cuda = device.type == "cuda"
        self.device = device
        view = np.uint16 if dtype == torch.int16 else np.uint32
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                     for _ in range(depth)]
        self.host_np = [h.numpy().view(view) for h in self.host]
        self.dev = ([torch.empty(shape, dtype=dtype, device=device)
                     for _ in range(depth)] if self.cuda else self.host)
        self.copied = [None] * depth
        self.consumed = [None] * depth
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.next = 0

    def acquire(self, timer=None) -> int:
        """The next slot, once the copy that last read it has completed
        (span ``lfs.stage.acquire``; ``timer``'s section ``slot_wait``)."""
        slot = self.next
        with profiling.span("lfs.stage.acquire", timer, "slot_wait", slot=slot):
            self.next = (slot + 1) % len(self.host)
            if self.copied[slot] is not None:
                self.copied[slot].synchronize()
        return slot

    def ship(self, slot: int, n: int, timer=None) -> torch.Tensor:
        """The first ``n`` entries of ``slot`` where the count runs. On a
        CUDA device the copy runs on the side stream, and the current
        (compute) stream waits for it. The span ``lfs.stage.ship``
        (``timer``'s section ``ship``) times the enqueue, not the copy."""
        src = self.host[slot][:n]
        with profiling.span("lfs.stage.ship", timer, bytes=src.nbytes):
            if not self.cuda:
                return src
            dst = self.dev[slot][:n]
            with torch.cuda.stream(self.copy_stream):
                if self.consumed[slot] is not None:
                    self.copy_stream.wait_event(self.consumed[slot])
                dst.copy_(src, non_blocking=True)
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


def ring(device) -> _Ring:
    """The staging ring of ``device`` at the current STAGE_WORDS: DEPTH
    slots of STAGE_WORDS int16 words (at least one transpose group),
    pinned on a CUDA device. Made at the first call and kept; its
    ``alloc_seconds`` is what making it took."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, STAGE_WORDS)
    if key not in _RINGS:
        t0 = time.perf_counter()
        r = _Ring((max(STAGE_WORDS, K.GROUP_WORDS),), torch.int16, dev, DEPTH)
        if r.cuda:
            torch.cuda.synchronize(dev)
        r.alloc_seconds = time.perf_counter() - t0
        _RINGS[key] = r
    return _RINGS[key]


def _copy_in(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a piece of the caller's column into a slot, on the host's
    intra-op threads."""
    with profiling.span("lfs.stage.copy_in", bytes=src.nbytes):
        dst.copy_(src)


def _pieces(columns, step: int):
    """(column index, start, stop) of every piece, the columns' pieces
    taken in turn, so that copies to different devices overlap."""
    longest = max((w.numel() for w, _ in columns), default=0)
    for a in range(0, longest, step):
        for i, (w, _) in enumerate(columns):
            if a < w.numel():
                yield i, a, min(a + step, w.numel())


def _raw_count(impl: str, report: bool):
    """The count of one shipped piece as one int64 tensor that sums
    across pieces: the kernel's per-stream sums (K1, K3, K5, K2), or K6's
    (C[k], F[k]) stacked."""
    if impl == "cuda_words":
        return lambda p: torch.stack(stream_sums_words_cuda(p))
    if impl == "cuda_pre":
        return lambda p: K.stream_sums_pre_cuda(p, report, packed=True)
    mode = "pospopcnt" if impl == "pospopcnt" else "flagstat_report" if report else "flagstat"
    return lambda p: K.stream_sums_cuda(p, mode)


def _streams(impl: str, report: bool, sums: torch.Tensor):
    """Summed counts of ``_raw_count`` -> (C[k], F[k]); K5's sums as
    they are."""
    if impl == "pospopcnt":
        return sums
    if impl == "cuda_words":
        return sums[0], sums[1]
    return K._sums_to_streams(sums, report)


def piece_sums(impl: str, piece: torch.Tensor, report: bool = False):
    """(C[k], F[k]) of one piece lying where it is counted, each (16,)
    int64, enqueued on the piece's device: ``"torch"`` the plain tier,
    ``"cuda"`` K1 (K3 with ``report``), ``"cuda_words"`` K6,
    ``"cuda_pre"`` K2 over packed plane tiles. The kernel impls take
    their plain versions on a CPU tensor."""
    if impl == "torch":
        return stream_sums_torch(piece)
    return _streams(impl, report, _raw_count(impl, report)(piece))


def staged_sums(columns, impl: str, report: bool = False) -> list:
    """Count host columns on their devices through the staging rings.

    ``columns``: (words, device) pairs, ``words`` a 1-D int16 tensor on
    the CPU. ``impl``: ``"cuda"``, ``"cuda_pre"`` or ``"cuda_words"``
    (``report``: K3's or K2's report streams) -> (C[k], F[k]) of each
    column, each (16,) int64 on its device; ``"pospopcnt"`` -> K5's
    (16,) sums of each column. ``cuda_pre``'s pieces are whole transpose
    groups, packed-transposed into the slots and shipped as plane tiles;
    the others' fall on multiples of 8 words. A column of 0 words
    launches nothing."""
    rows = K.packed_rows_for(report) if impl == "cuda_pre" else None
    granule = K.GROUP_WORDS if rows else 8
    step = max(STAGE_WORDS // granule, 1) * granule
    count = _raw_count(impl, report)
    with _LOCK:
        rings = [ring(dev) for _, dev in columns]
        acc = [None] * len(columns)
        for i, (words, _) in enumerate(columns):
            if not words.numel():
                shape = (0, len(rows), K.SUB, K.LANE) if rows else (0,)
                dtype = torch.int32 if rows else torch.int16
                acc[i] = count(torch.empty(shape, dtype=dtype, device=rings[i].device))
        for i, a, b in _pieces(columns, step):
            r = rings[i]
            slot = r.acquire()
            piece = columns[i][0][a:b]
            if rows:
                groups = -(-(b - a) // K.GROUP_WORDS)
                tiles = r.host_np[slot].view(np.uint32)[:groups * len(rows) * K.SUB * K.LANE]
                with profiling.span("lfs.stage.transpose", bytes=piece.nbytes):
                    pretranspose_host_packed(piece.numpy().view(np.uint16), rows,
                                             TRANSPOSE_THREADS,
                                             out=tiles.reshape(groups, len(rows), K.SUB, K.LANE))
                shipped = r.ship(slot, 2 * tiles.size).view(torch.int32).view(
                    groups, len(rows), K.SUB, K.LANE)
            else:
                _copy_in(r.host[slot][:b - a], piece)
                shipped = r.ship(slot, b - a)
            part = count(shipped)
            if acc[i] is None:
                acc[i] = part
            else:
                acc[i] += part
            r.release(slot)
            STAGED["pieces"] += 1
        STAGED["columns"] += len(columns)
    return [_streams(impl, report, s) for s in acc]

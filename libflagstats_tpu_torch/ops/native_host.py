"""ctypes wrappers for the native host flagstat/pospopcnt kernels: the
``"native"`` tier of the port.

The counterpart of ``libflagstats_tpu.ops.native_host`` (reference: the
entire libflagstats product is this tier — FLAGSTATS_u16,
libflagstats.h:3025). The kernels are the JAX package's C++ sources
(flagstats_host.cpp: AVX2 Harley-Seal CSA trees over the mask-select
transformed word streams), built and bound by the port's own loader,
io/native_lib.py. ``available()`` is False when the library cannot be
built; the wrappers then raise.
"""
from __future__ import annotations

import ctypes
import mmap

import numpy as np

from .. import flags as F
from ..io import native_lib


def available() -> bool:
    return native_lib.load() is not None


def _lib():
    lib = native_lib.load()
    if lib is None:
        raise RuntimeError(f"native host library unavailable: {native_lib.BUILD_ERROR}")
    return lib


def _check_out(counters: np.ndarray, n: int, what: str) -> None:
    """The C kernels write through a raw pointer: the out vector must be
    exactly what they assume — uint64, length n, C-contiguous, writable
    (a strided or read-only view would be silently corrupted/ignored)."""
    if (counters.dtype != np.uint64 or counters.size != n
            or not counters.flags["C_CONTIGUOUS"]
            or not counters.flags["WRITEABLE"]):
        raise ValueError(
            f"out must be a writable C-contiguous uint64[{n}] {what} vector")


def flagstat_native(array: np.ndarray, out=None, threads: int = 0) -> np.ndarray:
    """Flagstat counters via the native AVX2 kernel -> (32,) uint64.

    Accumulates into ``out`` when given (the reference streaming
    contract). ``threads``: 0 = hardware concurrency, 1 = single-thread.
    """
    lib = _lib()
    arr = np.ascontiguousarray(np.asarray(array, dtype=np.uint16)).ravel()
    counters = np.zeros(F.N_COUNTERS, dtype=np.uint64) if out is None else out
    _check_out(counters, F.N_COUNTERS, "counter")
    rc = lib.lfs_flagstat_u16(
        arr.ctypes.data_as(ctypes.c_void_p), arr.size,
        counters.ctypes.data_as(ctypes.c_void_p), threads)
    if rc != 0:
        raise RuntimeError(f"lfs_flagstat_u16 failed (rc={rc})")
    return counters


def flagstat_framed_native(path, codec: int, out=None, threads: int = 0,
                           byte_start: int = 0,
                           byte_stop: int | None = None
                           ) -> tuple[np.ndarray, int]:
    """Fused decode+count of a framed stream file, fully in C++.

    Each native worker decodes one block into a small thread-local
    buffer and counts it immediately — the decoded column never exists
    in memory (the reference's sequential decode-then-count loop,
    benchmark/flagstats.cpp:311-332, parallelized with the count
    fused). The file is mapped, not read. Returns (counters, n_words);
    accumulates into ``out`` when given.

    ``codec``: io.codec.CODEC_RAW/LZ4/ZSTD int id.
    ``byte_start``/``byte_stop``: count only this byte range, which
    must fall on frame boundaries (as computed by codec.scan_frames).
    """
    lib = _lib()
    counters = np.zeros(F.N_COUNTERS, dtype=np.uint64) if out is None else out
    _check_out(counters, F.N_COUNTERS, "counter")
    n_words = ctypes.c_int64(0)
    with open(path, "rb") as fh:
        size = fh.seek(0, 2)
        stop = size if byte_stop is None else byte_stop
        if not 0 <= byte_start <= stop <= size:
            raise ValueError(
                f"byte range [{byte_start}, {stop}) outside file of {size}")
        if stop == byte_start:
            return counters, 0
        with mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            if hasattr(mm, "madvise"):
                # async whole-range prefetch: cold demand paging faults
                # one page at a time (libflagstats_tpu/ops/native_host.py
                # measures it)
                mm.madvise(mmap.MADV_SEQUENTIAL)
                page0 = (byte_start // mmap.PAGESIZE) * mmap.PAGESIZE
                mm.madvise(mmap.MADV_WILLNEED, page0, stop - page0)
            view = np.frombuffer(mm, dtype=np.uint8)  # zero-copy, read-only
            try:
                rc = lib.lfs_flagstat_framed(
                    view[byte_start:stop].ctypes.data_as(ctypes.c_void_p),
                    stop - byte_start, int(codec), threads,
                    counters.ctypes.data_as(ctypes.c_void_p),
                    ctypes.byref(n_words))
            finally:
                del view  # release the buffer export before mm closes
    if rc != 0:
        raise ValueError(f"malformed or undecodable framed stream: {path}")
    return counters, int(n_words.value)


def flagstat_framed_range_native(path, codec: int, block_start: int,
                                 block_stop: int, out=None, threads: int = 0,
                                 frames=None) -> tuple[np.ndarray, int]:
    """Fused decode+count of blocks [block_start, block_stop) of a
    framed stream — the multi-host shard unit (codec.shard_block_ranges
    assigns contiguous block ranges per process). Pass ``frames`` (a
    codec.scan_frames result) to skip re-walking the headers."""
    if frames is None:
        from ..io import codec as C

        frames = C.scan_frames(path)
    if not 0 <= block_start <= block_stop <= len(frames):
        raise ValueError(
            f"block range [{block_start}, {block_stop}) outside "
            f"{len(frames)}-block stream")
    if block_start == block_stop:
        counters = (np.zeros(F.N_COUNTERS, dtype=np.uint64)
                    if out is None else out)
        _check_out(counters, F.N_COUNTERS, "counter")
        return counters, 0
    byte_start = frames[block_start][0] - 8
    byte_stop = frames[block_stop - 1][0] + frames[block_stop - 1][2]
    return flagstat_framed_native(path, codec, out=out, threads=threads,
                                  byte_start=byte_start, byte_stop=byte_stop)


def pospopcnt_native(array: np.ndarray, out=None, threads: int = 0) -> np.ndarray:
    """Positional popcount via the native AVX2 kernel -> (16,) uint64
    (reference: STORM_pospopcnt_u16, libalgebra.h:3497)."""
    lib = _lib()
    arr = np.ascontiguousarray(np.asarray(array, dtype=np.uint16)).ravel()
    counts = np.zeros(F.N_BITS, dtype=np.uint64) if out is None else out
    _check_out(counts, F.N_BITS, "bin")
    rc = lib.lfs_pospopcnt_u16(
        arr.ctypes.data_as(ctypes.c_void_p), arr.size,
        counts.ctypes.data_as(ctypes.c_void_p), threads)
    if rc != 0:
        raise RuntimeError(f"lfs_pospopcnt_u16 failed (rc={rc})")
    return counts

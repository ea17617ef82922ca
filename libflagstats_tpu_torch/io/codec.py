"""Framed block codec: the reference's compressed FLAG stream format.

A copy of ``libflagstats_tpu.io.codec`` bound to the port's own loader
of the native library (io/native_lib.py). The file format is the
contract between the two packages: a file one writes, the other reads,
and both reject the same corrupt headers (tests/test_torch_codec.py).

Per block: ``int32 uncompressed_size, int32 compressed_size, payload``
with 1,024,000-byte (512k-word) blocks (reference:
benchmark/flagstats.cpp:110-226, 136-138). Codecs: raw/stored, LZ4
(block format; effort 0 = LZ4-fast analogue, >0 = LZ4-HC analogue) and
Zstd. File naming mirrors the reference: ``<input>_HC_c{N}.lz4``,
``<input>_fast_a{N}.lz4``, ``<input>_c{N}.zst``
(benchmark/flagstats.cpp:114,151,196).

The native C++ library does the heavy lifting (multithreaded block
decode); pure-Python fallbacks keep everything functional without a
toolchain.
"""
from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from . import native_lib

BLOCK_BYTES = 1_024_000  # 512k words (reference: flagstats.cpp:136)

CODEC_RAW = 0
CODEC_LZ4 = 1
CODEC_ZSTD = 2

_CODEC_BY_NAME = {"raw": CODEC_RAW, "lz4": CODEC_LZ4, "zstd": CODEC_ZSTD}


def _codec_id(codec: str | int) -> int:
    if isinstance(codec, str):
        return _CODEC_BY_NAME[codec]
    return int(codec)


# ---------------------------------------------------------------------------
# Pure-Python LZ4 block codec (fallback; clean-room from the public spec)
# ---------------------------------------------------------------------------

def _lz4_decompress_py(src: bytes, dst_len: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    try:
        while i < n:
            token = src[i]; i += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    b = src[i]; i += 1
                    lit += b
                    if b != 255:
                        break
            out += src[i:i + lit]
            i += lit
            if i >= n:
                break
            offset = src[i] | (src[i + 1] << 8)
            i += 2
            mlen = (token & 0x0F) + 4
            if (token & 0x0F) == 15:
                while True:
                    b = src[i]; i += 1
                    mlen += b
                    if b != 255:
                        break
            start = len(out) - offset
            if start < 0:
                raise ValueError("corrupt LZ4 block: bad offset")
            for k in range(mlen):  # may overlap: copy byte-wise
                out.append(out[start + k])
    except IndexError as exc:
        # truncation inside a length/offset field — same ValueError
        # contract as every other corrupt-input path (the native decoder
        # signals the identical condition with -1)
        raise ValueError("corrupt LZ4 block: truncated sequence") from exc
    if len(out) != dst_len:
        raise ValueError(f"corrupt LZ4 block: got {len(out)}, want {dst_len}")
    return bytes(out)


def _lz4_compress_py(src: bytes) -> bytes:
    """Minimal valid LZ4 block: a single all-literal sequence."""
    n = len(src)
    out = bytearray()
    l = n
    if l >= 15:
        out.append(15 << 4)
        l -= 15
        while l >= 255:
            out.append(255)
            l -= 255
        out.append(l)
    else:
        out.append(l << 4)
    out += src
    return bytes(out)


# ---------------------------------------------------------------------------
# Zstd fallback via system libzstd (no build step needed)
# ---------------------------------------------------------------------------

_zstd = None


def _libzstd():
    global _zstd
    if _zstd is None:
        lib = ctypes.CDLL("libzstd.so.1")
        for name, res in (("ZSTD_compress", ctypes.c_size_t),
                          ("ZSTD_decompress", ctypes.c_size_t),
                          ("ZSTD_compressBound", ctypes.c_size_t),
                          ("ZSTD_isError", ctypes.c_uint)):
            getattr(lib, name).restype = res
        _zstd = lib
    return _zstd


# ---------------------------------------------------------------------------
# Single-block compress/decompress (native when available)
# ---------------------------------------------------------------------------

def _lz4_effort(level: int) -> int:
    """CLI level -> native effort. Reference knobs: LZ4-HC level c
    (flagstats.cpp:147) and LZ4-fast acceleration a (flagstats.cpp:110).

      level >= 2  -> LZ4-HC at that level         (effort = level)
      level == 1  -> LZ4-fast, acceleration 1     (effort = 0)
      level <= 0  -> LZ4-fast, acceleration 1-level (effort = level)
    """
    return 0 if level == 1 else level


def compress_block(data: bytes, codec: str | int, level: int = 1) -> bytes:
    cid = _codec_id(codec)
    if cid == CODEC_RAW:
        return data
    lib = native_lib.load()
    if cid == CODEC_LZ4:
        if lib is None:
            return _lz4_compress_py(data)
        bound = lib.lfs_lz4_bound(len(data))
        dst = ctypes.create_string_buffer(bound)
        r = lib.lfs_lz4_compress(data, len(data), dst, bound,
                                 _lz4_effort(level))
        if r < 0:
            raise RuntimeError("lz4 compress failed")
        return dst.raw[:r]
    if cid == CODEC_ZSTD:
        if lib is not None:
            bound = lib.lfs_zstd_bound(len(data))
            dst = ctypes.create_string_buffer(bound)
            r = lib.lfs_zstd_compress(data, len(data), dst, bound, level)
            if r < 0:
                raise RuntimeError("zstd compress failed")
            return dst.raw[:r]
        z = _libzstd()
        bound = z.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(bound)
        r = z.ZSTD_compress(dst, bound, data, len(data), level)
        if z.ZSTD_isError(r):
            raise RuntimeError("zstd compress failed")
        return dst.raw[:r]
    raise ValueError(f"unknown codec {codec}")


def decompress_block(data: bytes, raw_len: int, codec: str | int) -> bytes:
    cid = _codec_id(codec)
    if cid == CODEC_RAW:
        if len(data) != raw_len:
            # match the native decoder (src_len != raw_len -> reject):
            # a truncated raw frame must not silently yield short counts
            raise ValueError(
                f"corrupt raw block: got {len(data)} bytes, want {raw_len}")
        return data
    lib = native_lib.load()
    if cid == CODEC_LZ4:
        if lib is None:
            return _lz4_decompress_py(data, raw_len)
        dst = ctypes.create_string_buffer(raw_len)
        r = lib.lfs_lz4_decompress(data, len(data), dst, raw_len)
        if r != raw_len:
            raise RuntimeError("lz4 decompress failed")
        return dst.raw
    if cid == CODEC_ZSTD:
        dst = ctypes.create_string_buffer(raw_len)
        if lib is not None:
            r = lib.lfs_zstd_decompress(data, len(data), dst, raw_len)
        else:
            z = _libzstd()
            r = z.ZSTD_decompress(dst, raw_len, data, len(data))
            if z.ZSTD_isError(r):
                r = -1
        if r != raw_len:
            raise RuntimeError("zstd decompress failed")
        return dst.raw
    raise ValueError(f"unknown codec {codec}")


# ---------------------------------------------------------------------------
# Framed streams
# ---------------------------------------------------------------------------

@dataclass
class FramedStreamInfo:
    n_blocks: int
    raw_bytes: int
    compressed_bytes: int


def write_framed(path, flags: np.ndarray, codec: str | int = "lz4",
                 level: int = 1, block_bytes: int | None = None,
                 threads: int = 0) -> FramedStreamInfo:
    """FLAG array -> framed compressed stream on disk
    (reference: `bench compress`, benchmark/flagstats.cpp:738-826).

    ``block_bytes`` defaults to CONFIG.block_bytes (reference-compatible
    1,024,000). Blocks compress in parallel on a thread pool (the
    native codecs release the GIL under ctypes; the reference
    compresses sequentially) with a bounded in-flight window, written
    to disk in stream order."""
    import concurrent.futures as cf
    from collections import deque

    if block_bytes is None:
        from ..config import CONFIG

        block_bytes = CONFIG.block_bytes
    if threads <= 0:
        import os

        threads = min(8, os.cpu_count() or 1)
    flags = np.ascontiguousarray(np.asarray(flags, dtype=np.uint16))
    raw = memoryview(flags).cast("B")  # zero-copy; per-block .tobytes only
    n_blocks = 0
    comp_total = 0
    with open(path, "wb") as f, cf.ThreadPoolExecutor(threads) as pool:
        futs: deque = deque()

        def drain_one():
            nonlocal n_blocks, comp_total
            raw_len, fut = futs.popleft()
            payload = fut.result()
            f.write(struct.pack("<ii", raw_len, len(payload)))
            f.write(payload)
            n_blocks += 1
            comp_total += len(payload)

        for off in range(0, len(raw), block_bytes):
            chunk = raw[off:off + block_bytes].tobytes()
            futs.append((len(chunk),
                         pool.submit(compress_block, chunk, codec, level)))
            if len(futs) >= 4 * threads:
                drain_one()
        while futs:
            drain_one()
    return FramedStreamInfo(n_blocks, len(raw), comp_total)


def iter_framed(path) -> Iterator[tuple[int, bytes]]:
    """Yield (raw_len, payload) per block of a framed stream."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise ValueError("truncated frame header")
            raw_len, comp_len = struct.unpack("<ii", header)
            if raw_len < 0 or comp_len < 0:
                raise ValueError("corrupt frame header (negative length)")
            if raw_len % 2:
                # uint16 payloads only — keep both parsers of this
                # untrusted header (scan_frames / here) rejecting
                # identical inputs identically
                raise ValueError("corrupt frame header (odd raw length)")
            payload = f.read(comp_len)
            if len(payload) != comp_len:
                raise ValueError("truncated frame payload")
            yield raw_len, payload


def read_framed(path, codec: str | int, n_threads: int = 0) -> np.ndarray:
    """Decode a whole framed stream -> uint16 array.

    Uses the native multithreaded block decoder when available; the
    pure-Python path decodes sequentially."""
    cid = _codec_id(codec)
    data = Path(path).read_bytes()
    lib = native_lib.load()
    if lib is not None:
        # one validated header walk for all callers: scan_frames enforces
        # the negative/odd-raw_len rejections (odd raw_len would make the
        # native decoder write raw_total bytes into a raw_total//2-word
        # buffer — advisor finding, round 1) AND rejects trailing
        # garbage, which the previous inline walk silently skipped
        raw_total = sum(r for _, r, _ in scan_frames(path))
        out = np.empty(raw_total // 2, dtype=np.uint16)
        r = lib.lfs_decode_stream(
            data, len(data), out.ctypes.data_as(ctypes.c_void_p), raw_total,
            cid, n_threads,
        )
        if r != raw_total:
            raise RuntimeError("framed stream decode failed")
        return out
    parts = [decompress_block(payload, raw_len, cid)
             for raw_len, payload in iter_framed(path)]
    return np.frombuffer(b"".join(parts), dtype=np.uint16).copy()


def iter_framed_blocks(path, codec: str | int) -> Iterator[np.ndarray]:
    """Streaming block-by-block decode -> uint16 arrays (the shape of the
    reference's accumulate-per-block loop, flagstats.cpp:311-332)."""
    cid = _codec_id(codec)
    for raw_len, payload in iter_framed(path):
        yield np.frombuffer(decompress_block(payload, raw_len, cid),
                            dtype=np.uint16)


def scan_frames(path) -> list[tuple[int, int, int]]:
    """Index a framed stream without decoding: per block
    (file_offset_of_payload, raw_len, comp_len). Used to assign block
    ranges to processes in multi-host runs."""
    frames = []
    off = 0
    size = Path(path).stat().st_size
    with open(path, "rb") as f:
        while off + 8 <= size:
            raw_len, comp_len = struct.unpack("<ii", f.read(8))
            if raw_len < 0 or comp_len < 0:
                raise ValueError("corrupt frame header (negative length)")
            if raw_len % 2:
                raise ValueError("corrupt frame header (odd raw length)")
            frames.append((off + 8, raw_len, comp_len))
            off += 8 + comp_len
            f.seek(off)
    if off != size:
        raise ValueError("trailing garbage in framed stream")
    return frames


def read_framed_range(path, codec: str | int, block_start: int, block_stop: int,
                      n_threads: int = 0) -> np.ndarray:
    """Decode blocks [block_start, block_stop) of a framed stream.

    The shard unit for multi-host streaming: process p of P reads only
    its contiguous block range (reference decomposition: the sequential
    512k-record block loop, flagstats.cpp:311-332, gone parallel)."""
    cid = _codec_id(codec)
    frames = scan_frames(path)[block_start:block_stop]
    if not frames:
        return np.zeros(0, dtype=np.uint16)
    lib = native_lib.load()
    with open(path, "rb") as f:
        if lib is not None:
            # re-frame the byte range and reuse the parallel decoder
            chunks = []
            for off, raw_len, comp_len in frames:
                f.seek(off - 8)
                chunks.append(f.read(8 + comp_len))
            data = b"".join(chunks)
            raw_total = sum(r for _, r, _ in frames)
            out = np.empty(raw_total // 2, dtype=np.uint16)
            r = lib.lfs_decode_stream(
                data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                raw_total, cid, n_threads,
            )
            if r != raw_total:
                raise RuntimeError("framed range decode failed")
            return out
        parts = []
        for off, raw_len, comp_len in frames:
            f.seek(off)
            parts.append(decompress_block(f.read(comp_len), raw_len, cid))
    return np.frombuffer(b"".join(parts), dtype=np.uint16).copy()


def shard_block_ranges(n_blocks: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous near-equal block ranges for n_shards processes."""
    base, rem = divmod(n_blocks, n_shards)
    ranges = []
    start = 0
    for p in range(n_shards):
        stop = start + base + (1 if p < rem else 0)
        ranges.append((start, stop))
        start = stop
    return ranges


def codec_filename(base: str, codec: str, level: int) -> str:
    """Reference output naming (benchmark/flagstats.cpp:114,151,196);
    lz4 level <= 1 is the LZ4-fast family with acceleration
    1 - _lz4_effort(level): levels 1 and 0 -> a1, level -1 -> a2,
    level -9 -> a10."""
    if codec == "lz4":
        if level > 1:
            return f"{base}_HC_c{level}.lz4"
        return f"{base}_fast_a{1 - _lz4_effort(level)}.lz4"
    if codec == "zstd":
        return f"{base}_c{level}.zst"
    return f"{base}.bin"

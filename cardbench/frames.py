"""The framed file of a column, written with a system codec library.

Upstream's `bench compress` format (benchmark/flagstats.cpp:738-826):
per block of ``block_bytes`` raw bytes, ``[int32 raw_len][int32
comp_len][payload]``, little-endian. Payloads come from the codec that
the configuration's ``frames`` names, a module of ``codecs/`` that
calls the system library through ctypes, on a thread pool (ctypes
releases the interpreter lock), never from the program's codec.

The file is an unnamed temporary file in ``TMPDIR`` (``O_TMPFILE``
where the file system has it, else unlinked at once), written once and
left in the page cache. The program opens it by ``/proc/<pid>/fd/<n>``:
the same inode, mapped as any file, and no name is ever left behind,
whatever way the process ends. (A memfd would write no disk block, but
on the H100's host the stream read it 2.5-3x slower than a file.)
"""
from __future__ import annotations

import os
import struct
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .spec import module

_HEADER = struct.Struct("<ii")


def codec(spec: dict):
    """The codec of a configuration's ``frames`` spec: the module
    ``codecs/<codec>.py``, built with the spec's ``level``."""
    return module("codecs", spec["codec"]).Codec(int(spec["level"]))


def temp_file():
    """(file object, path) of an unnamed file under TMPDIR; closing the
    file frees it."""
    f = tempfile.TemporaryFile(buffering=0)
    return f, f"/proc/{os.getpid()}/fd/{f.fileno()}"


def write_frames(words: np.ndarray, spec: dict, fd: int, threads: int = 8) -> dict:
    """Write the framed file of ``words`` (uint16) to ``fd``; returns
    {"frames", "raw_bytes", "file_bytes"}."""
    words = np.ascontiguousarray(words)
    cdc = codec(spec)
    block = int(spec["block_bytes"])
    nbytes = words.nbytes
    base = words.ctypes.data
    starts = range(0, nbytes, block)

    def one(off):
        n = min(block, nbytes - off)
        return n, cdc.compress(base + off, n)

    size = 0
    with ThreadPoolExecutor(threads) as pool, \
            os.fdopen(fd, "wb", buffering=1 << 22, closefd=False) as f:
        for n, payload in pool.map(one, starts):
            f.write(_HEADER.pack(n, len(payload)))
            f.write(payload)
            size += _HEADER.size + len(payload)
    return {"frames": len(starts), "raw_bytes": nbytes, "file_bytes": size}


def read_frames(path: str, spec: dict) -> np.ndarray:
    """Decode a framed file back to its uint16 words (for tests)."""
    cdc = codec(spec)
    with open(path, "rb") as f:
        data = f.read()
    parts, pos = [], 0
    while pos < len(data):
        raw_len, comp_len = _HEADER.unpack_from(data, pos)
        pos += _HEADER.size
        parts.append(cdc.decompress(data[pos:pos + comp_len], raw_len))
        pos += comp_len
    return np.frombuffer(b"".join(parts), dtype=np.uint16)

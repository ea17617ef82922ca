"""CRAM 3.0 ingest, FLAG column only: the port of
``libflagstats_tpu.io.cramio``.

samtools flagstat on the NA12878 CRAM is the reference's published
comparison point (4m50.68s); the reference itself reads no container.

CRAM is columnar: every data series lives in its own (per-slice)
block, so a flagstat engine can decode ONLY the flag-bearing series
and skip sequences/qualities/names entirely — the same trick the
packed plane layout plays on the device side. The series that
reconstruct a BAM FLAG (htslib convention):

  BF  BAM bit flags with the mate bits (0x8 MUNMAP, 0x20 MREVERSE)
      stripped — they are carried separately so mates stored in the
      same slice can share them;
  CF  CRAM bit flags: 0x2 = mate is DETACHED (its mate info, incl.
      MF, is spelled out rather than derived from a neighbour record);
  MF  mate flags for detached records: 0x1 = mate negative strand
      (-> 0x20), 0x2 = mate unmapped (-> 0x8).

Scope (documented subset): this reader handles any CRAM whose
BF/CF/MF series use the EXTERNAL encoding (codec id 1 — what htslib
emits) in raw or gzip blocks, with mates DETACHED or unpaired. A CRAM
using within-slice mate linking (CF bit 0x4 without 0x2) stores the
mate bits only on the mate record itself; reconstructing them needs
the full record decode this reader deliberately avoids, so it raises
a clear error instead of miscounting. Unsupported encodings/codecs
likewise error, never guess.

Structural integrity is enforced: the container-header CRC32, every
block CRC32, itf8/ltf8 bounds, declared vs actual sizes, and
record-count consistency all gate the walk (hostile-input fuzz:
tests/test_cramio.py, tests/test_torch_cramio.py).

The writer emits the same subset spec-conformly (file definition,
SAM-header container, per-container compression header + one slice,
EXTERNAL itf8 series, empty core block, canonical EOF container) —
the repo's established synthesize-then-ingest conformance pattern
(io/bamio.py, io/samio.py): the tests need no samtools to make
files, so the writer is the spec oracle and hostile mutations of its
output drive the reader's error paths.

The native pieces come from the port's loader (io/native_lib.py): the
container column reader (the port's cram_columns.cpp, the column twin
of the fused walker) from the column readers (``load_columns()``), the
rANS-4x8 codec and the fused container walker (cram_reader.cpp) from
the readers' library (``load_readers()``), the itf8 stream decoder from
the host library (``load()``). ``read_cram_flags`` reads the column
with the column reader; where the native readers did not build, it
takes ``read_cram_flags_py``, the Python container walk (rANS decoded
in Python), and ``READ_ROUTE`` and one line on standard error say so,
as in io/bamio.py and io/samio.py.

Counting differs from the JAX package on purpose: ``flagstat_cram``
and ``flagstat_cram_range`` read the column and count it on the card
(``impl=None``), on the CPU (``device="cpu"``) or with any tier named
by ``impl``; the fused host walk+count runs only when ``impl="native"``
names it.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native_lib

#: "native" or "python": the route the last read_cram_flags or
#: flagstat_cram_range call took
READ_ROUTE: str | None = None

CRAM_MAGIC = b"CRAM\x03\x00"
#: canonical 38-byte EOF container (CRAM 3.0 §9; also recognised
#: structurally — a zero-record container whose first block is an
#: empty compression header — so a non-canonical-but-valid EOF still
#: terminates the walk cleanly)
EOF_CONTAINER = bytes([
    0x0f, 0x00, 0x00, 0x00, 0xff, 0xff, 0xff, 0xff, 0x0f, 0xe0,
    0x45, 0x4f, 0x46, 0x00, 0x00, 0x00, 0x00, 0x01, 0x00, 0x05,
    0xbd, 0xd9, 0x4f, 0x00, 0x01, 0x00, 0x06, 0x06, 0x01, 0x00,
    0x01, 0x00, 0x01, 0x00, 0xee, 0x63, 0x01, 0x4b,
])

#: block compression methods (CRAM 3.0 §8)
RAW, GZIP, RANS = 0, 1, 4
#: block content types
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5
#: encoding codec ids (§12) — EXTERNAL is the only one this subset uses
ENC_NULL, ENC_EXTERNAL = 0, 1
#: external block content ids our writer assigns
ID_BF, ID_CF, ID_MF = 1, 2, 3

_MATE_BITS = 0x8 | 0x20          # FMUNMAP | FMREVERSE, carried in MF
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4


# ---------------------------------------------------------------------------
# itf8 / ltf8 (§2.3): variable-length int32/int64
# ---------------------------------------------------------------------------


def itf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    # 5-byte form: only the LOW 4 bits of the 5th byte are used (§2.3)
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def itf8_decode(buf, off: int) -> tuple[int, int]:
    """(value as signed int32, new offset); raises ValueError on
    truncation."""
    try:
        b0 = buf[off]
    except IndexError:
        raise ValueError("itf8: truncated") from None
    if b0 < 0x80:
        v, off = b0, off + 1
    elif b0 < 0xC0:
        end = off + 2
        if end > len(buf):
            raise ValueError("itf8: truncated")
        v = ((b0 & 0x3F) << 8) | buf[off + 1]
        off = end
    elif b0 < 0xE0:
        end = off + 3
        if end > len(buf):
            raise ValueError("itf8: truncated")
        v = ((b0 & 0x1F) << 16) | (buf[off + 1] << 8) | buf[off + 2]
        off = end
    elif b0 < 0xF0:
        end = off + 4
        if end > len(buf):
            raise ValueError("itf8: truncated")
        v = ((b0 & 0x0F) << 24) | (buf[off + 1] << 16) | \
            (buf[off + 2] << 8) | buf[off + 3]
        off = end
    else:
        end = off + 5
        if end > len(buf):
            raise ValueError("itf8: truncated")
        v = ((b0 & 0x0F) << 28) | (buf[off + 1] << 20) | \
            (buf[off + 2] << 12) | (buf[off + 3] << 4) | \
            (buf[off + 4] & 0x0F)
        off = end
    if v >= 1 << 31:
        v -= 1 << 32
    return v, off


def ltf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    out = []
    n = (v.bit_length() + 7) // 8        # payload bytes needed
    # leading byte carries (8 - extra) value bits under an `extra`-ones
    # prefix; 0xFF prefix = 8 full payload bytes
    for extra in range(1, 8):
        if v < 1 << (7 - extra + 8 * extra):
            prefix = (0xFF << (8 - extra)) & 0xFF
            payload = v.to_bytes(extra + 1, "big")
            head = prefix | payload[0]
            if payload[0] >> (8 - extra):
                break                     # value bits collide with prefix
            return bytes([head]) + payload[1:]
    return bytes([0xFF]) + v.to_bytes(8, "big")


def ltf8_decode(buf, off: int) -> tuple[int, int]:
    try:
        b0 = buf[off]
    except IndexError:
        raise ValueError("ltf8: truncated") from None
    extra = 0
    mask = 0x80
    while extra < 8 and (b0 & mask):
        extra += 1
        mask >>= 1
    end = off + 1 + extra
    if end > len(buf):
        raise ValueError("ltf8: truncated")
    if extra == 8:
        v = int.from_bytes(buf[off + 1:end], "big")
    else:
        v = b0 & (0xFF >> extra) if extra else b0
        v = int.from_bytes(bytes([v & 0xFF]) + bytes(buf[off + 1:end]),
                           "big")
    if v >= 1 << 63:
        v -= 1 << 64
    return v, off + 1 + extra


def itf8_encode_stream(vals: np.ndarray) -> bytes:
    """Vectorized itf8 encoding of an int array (the per-value
    itf8_encode is the executable spec; this must match it byte for
    byte — tested)."""
    v = (np.asarray(vals).astype(np.int64) & 0xFFFFFFFF)
    lens = np.select(
        [v < 0x80, v < 0x4000, v < 0x200000, v < 0x10000000],
        [1, 2, 3, 4], default=5)
    offs = np.zeros(v.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    buf = np.zeros(int(offs[-1]), dtype=np.uint8)
    o = offs[:-1]
    m = lens == 1
    buf[o[m]] = v[m]
    m = lens == 2
    buf[o[m]] = 0x80 | (v[m] >> 8)
    buf[o[m] + 1] = v[m] & 0xFF
    m = lens == 3
    buf[o[m]] = 0xC0 | (v[m] >> 16)
    buf[o[m] + 1] = (v[m] >> 8) & 0xFF
    buf[o[m] + 2] = v[m] & 0xFF
    m = lens == 4
    buf[o[m]] = 0xE0 | (v[m] >> 24)
    buf[o[m] + 1] = (v[m] >> 16) & 0xFF
    buf[o[m] + 2] = (v[m] >> 8) & 0xFF
    buf[o[m] + 3] = v[m] & 0xFF
    m = lens == 5
    buf[o[m]] = 0xF0 | ((v[m] >> 28) & 0x0F)
    buf[o[m] + 1] = (v[m] >> 20) & 0xFF
    buf[o[m] + 2] = (v[m] >> 12) & 0xFF
    buf[o[m] + 3] = (v[m] >> 4) & 0xFF
    buf[o[m] + 4] = v[m] & 0x0F
    return buf.tobytes()


def itf8_decode_stream(buf: bytes, n: int) -> np.ndarray:
    """Decode exactly n itf8 values from buf -> int32 ndarray.

    Native (lfs_itf8_decode of the host library) when it built; pure
    Python otherwise. Raises ValueError on truncation or trailing
    garbage (a conformant series block holds exactly its values)."""
    lib = native_lib.load()
    if lib is not None:
        import ctypes

        src = np.frombuffer(buf, dtype=np.uint8)
        out = np.empty(n, dtype=np.int32)
        used = lib.lfs_itf8_decode(
            src.ctypes.data_as(ctypes.c_void_p), src.size,
            out.ctypes.data_as(ctypes.c_void_p), n)
        if used < 0:
            raise ValueError("itf8 stream: truncated")
        if used != len(buf):
            raise ValueError("itf8 stream: trailing bytes in series block")
        return out
    out = np.empty(n, dtype=np.int32)
    off = 0
    for i in range(n):
        out[i], off = itf8_decode(buf, off)
    if off != len(buf):
        raise ValueError("itf8 stream: trailing bytes in series block")
    return out


# ---------------------------------------------------------------------------
# blocks and maps
# ---------------------------------------------------------------------------


def _rans_compress(data: bytes) -> bytes:
    lib = native_lib.load_readers()
    if lib is None:
        raise RuntimeError(
            "rANS block compression needs the native readers "
            f"(io/csrc/rans4x8.cpp), which did not build: "
            f"{native_lib.READERS_BUILD_ERROR}; use method=GZIP otherwise")
    import ctypes

    src = np.frombuffer(data, dtype=np.uint8)
    cap = int(lib.lfs_rans4x8_bound(src.size))
    out = np.empty(cap, dtype=np.uint8)
    got = lib.lfs_rans4x8_compress(
        src.ctypes.data_as(ctypes.c_void_p), src.size,
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if got < 0:
        raise RuntimeError("rANS compression failed")
    return out[:got].tobytes()


def _rans_decompress(comp: bytes, raw_size: int) -> bytes:
    lib = native_lib.load_readers()
    if lib is not None:
        import ctypes

        src = np.frombuffer(comp, dtype=np.uint8)
        out = np.empty(max(raw_size, 1), dtype=np.uint8)
        got = lib.lfs_rans4x8_decompress(
            src.ctypes.data_as(ctypes.c_void_p), src.size,
            out.ctypes.data_as(ctypes.c_void_p), raw_size)
        if got == -3:
            raise ValueError(
                "rANS order-1 block: not supported by the CRAM subset "
                "reader (order-0 only)")
        if got < 0:
            raise ValueError("rANS block: corrupt stream")
        return out[:got].tobytes()
    return _rans_decompress_py(comp)


def _rans_decompress_py(comp: bytes) -> bytes:
    """Pure-Python rANS-4x8 order-0 decoder (the route without the
    readers; the native decoder is the fast path — this one is the
    executable spec and the differential test partner)."""
    if len(comp) < 9:
        raise ValueError("rANS block: truncated header")
    order = comp[0]
    if order == 1:
        raise ValueError(
            "rANS order-1 block: not supported by the CRAM subset "
            "reader (order-0 only)")
    if order != 0:
        raise ValueError("rANS block: bad order byte")
    remainder = int.from_bytes(comp[1:5], "little")
    raw = int.from_bytes(comp[5:9], "little")
    if 9 + remainder > len(comp):
        raise ValueError("rANS block: truncated vs declared size")
    if raw == 0:
        return b""
    buf = comp[9:9 + remainder]
    off = 0

    F = [0] * 256
    rle = 0
    if not buf:
        raise ValueError("rANS block: missing frequency table")
    j = buf[off]
    off += 1
    total = 0
    while True:
        if off >= len(buf):
            raise ValueError("rANS block: truncated frequency table")
        f = buf[off]
        off += 1
        if f >= 0x80:
            if off >= len(buf):
                raise ValueError("rANS block: truncated frequency")
            f = ((f & 0x7F) << 8) | buf[off]
            off += 1
        if f == 0 or F[j]:
            raise ValueError("rANS block: bad frequency table")
        F[j] = f
        total += f
        if total > 4096:
            raise ValueError("rANS block: frequencies exceed 4096")
        if rle:
            rle -= 1
            j += 1
            if j > 255:
                raise ValueError("rANS block: run past symbol 255")
            continue
        if off >= len(buf):
            raise ValueError("rANS block: truncated table")
        nj = buf[off]
        off += 1
        if nj == 0:
            break
        if nj == j + 1:
            if off >= len(buf):
                raise ValueError("rANS block: truncated run length")
            rle = buf[off]
            off += 1
        j = nj
    if total != 4096:
        raise ValueError("rANS block: frequency total != 4096")
    C = [0] * 257
    for s in range(256):
        C[s + 1] = C[s] + F[s]
    cum2sym = bytearray(4096)
    for s in range(256):
        for c in range(C[s], C[s + 1]):
            cum2sym[c] = s

    R = []
    for _ in range(4):
        if off + 4 > len(buf):
            raise ValueError("rANS block: truncated states")
        R.append(int.from_bytes(buf[off:off + 4], "little"))
        off += 4
        if R[-1] < 1 << 23:
            raise ValueError("rANS block: invalid initial state")
    out = bytearray(raw)
    for i in range(raw):
        st = R[i & 3]
        c = st & 0xFFF
        s = cum2sym[c]
        out[i] = s
        st = F[s] * (st >> 12) + c - C[s]
        while st < 1 << 23:
            if off >= len(buf):
                raise ValueError("rANS block: stream exhausted")
            st = (st << 8) | buf[off]
            off += 1
        R[i & 3] = st
    return bytes(out)


def _write_block(method: int, ctype: int, content_id: int,
                 data: bytes) -> bytes:
    if method == GZIP:
        import gzip as _gzip

        comp = _gzip.compress(data, 6, mtime=0)
    elif method == RANS:
        comp = _rans_compress(data)
    else:
        comp = data
    body = (bytes([method, ctype]) + itf8_encode(content_id)
            + itf8_encode(len(comp)) + itf8_encode(len(data)) + comp)
    return body + struct.pack("<I", zlib.crc32(body))


def _read_block(buf, off: int):
    """-> (dict, new_off); validates the block CRC and sizes."""
    start = off
    if off + 2 > len(buf):
        raise ValueError("block: truncated header")
    method, ctype = buf[off], buf[off + 1]
    off += 2
    content_id, off = itf8_decode(buf, off)
    comp_size, off = itf8_decode(buf, off)
    raw_size, off = itf8_decode(buf, off)
    if comp_size < 0 or raw_size < 0:
        raise ValueError("block: negative size")
    if comp_size > len(buf) - off:
        raise ValueError("block: compressed size past container end")
    comp = bytes(buf[off:off + comp_size])
    off += comp_size
    if off + 4 > len(buf):
        raise ValueError("block: truncated CRC")
    (crc,) = struct.unpack_from("<I", buf, off)
    if zlib.crc32(bytes(buf[start:off])) != crc:
        raise ValueError("block: CRC mismatch")
    off += 4
    if method == RAW:
        data = comp
    elif method == GZIP:
        try:
            data = zlib.decompress(comp, wbits=31)
        except zlib.error as e:
            raise ValueError(f"block: bad gzip stream ({e})") from None
    elif method == RANS:
        data = _rans_decompress(comp, raw_size)
    else:
        raise ValueError(
            f"block: compression method {method} not supported by the "
            "CRAM subset reader (raw/gzip/rans4x8)")
    if len(data) != raw_size:
        raise ValueError(
            f"block: raw size mismatch (declared {raw_size}, got "
            f"{len(data)})")
    return {"method": method, "ctype": ctype, "id": content_id,
            "data": data}, off


def _write_map(entries: list[tuple[bytes, bytes]]) -> bytes:
    body = itf8_encode(len(entries)) + b"".join(
        k + v for k, v in entries)
    return itf8_encode(len(body)) + body


def _read_map(buf, off: int):
    """-> (n_entries, entries_offset, end_offset)."""
    size, off = itf8_decode(buf, off)
    if size < 0 or off + size > len(buf):
        raise ValueError("map: size out of bounds")
    end = off + size
    n, boff = itf8_decode(buf, off)
    if n < 0:
        raise ValueError("map: negative entry count")
    return n, boff, end


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_SAM_HEADER = b"@HD\tVN:1.6\tSO:unsorted\n"


def _compression_header_block(method: int) -> bytes:
    pres = _write_map([(b"RN", b"\x01"), (b"AP", b"\x00"),
                       (b"RR", b"\x00")])
    ext = {b"BF": ID_BF, b"CF": ID_CF, b"MF": ID_MF}
    ds = _write_map([
        (key, itf8_encode(ENC_EXTERNAL)
         + itf8_encode(len(itf8_encode(cid))) + itf8_encode(cid))
        for key, cid in ext.items()
    ])
    tags = _write_map([])
    return _write_block(RAW, CT_COMPRESSION_HEADER, 0, pres + ds + tags)


def _slice_blocks(flags: np.ndarray, counter: int, method: int) -> bytes:
    n = flags.size
    f32 = flags.astype(np.int64)
    bf = (f32 & ~np.int64(_MATE_BITS)).astype(np.int64)
    # every record is written DETACHED: MF then carries the mate bits
    # for all records, so arbitrary FLAG words (e.g. mate bits set on
    # unpaired reads, legal in the conformance corpus) roundtrip
    # exactly — real aligner output would mark only paired-without-
    # in-slice-mate records detached, which the reader equally accepts
    cf = np.full(n, CF_DETACHED, dtype=np.int64)
    mf = ((f32 >> 5) & 1) | (((f32 >> 3) & 1) << 1)

    ext = [(ID_BF, itf8_encode_stream(bf)),
           (ID_CF, itf8_encode_stream(cf)),
           (ID_MF, itf8_encode_stream(mf))]
    core = _write_block(RAW, CT_CORE, 0, b"")
    ext_blocks = [_write_block(method, CT_EXTERNAL, cid, data)
                  for cid, data in ext]
    head = (itf8_encode(-1)                    # ref seq id (unmapped)
            + itf8_encode(0) + itf8_encode(0)  # start, span
            + itf8_encode(n)
            + ltf8_encode(counter)
            + itf8_encode(1 + len(ext_blocks))  # core + externals
            + itf8_encode(len(ext))
            + b"".join(itf8_encode(cid) for cid, _ in ext)
            + itf8_encode(-1)                  # embedded ref content id
            + b"\x00" * 16)                    # reference MD5
    return [_write_block(RAW, CT_SLICE_HEADER, 0, head), core,
            *ext_blocks]


def _container_bytes(blocks: list[bytes], n_records: int,
                     counter: int) -> bytes:
    """Container header + concatenated blocks. Landmarks point at each
    slice start (here: the second block — compression header first)."""
    body = b"".join(blocks)
    landmarks = []
    if len(blocks) > 1:
        landmarks = [len(blocks[0])]       # one slice per container
    head_wo_len = (itf8_encode(-1)
                   + itf8_encode(0) + itf8_encode(0)
                   + itf8_encode(n_records)
                   + ltf8_encode(counter)
                   + ltf8_encode(0)
                   + itf8_encode(len(blocks))
                   + itf8_encode(len(landmarks))
                   + b"".join(itf8_encode(v) for v in landmarks))
    head = struct.pack("<i", len(body)) + head_wo_len
    crc = struct.pack("<I", zlib.crc32(head))
    return head + crc + body


def write_cram(path, flags, records_per_container: int = 1 << 20,
               method: int = GZIP) -> int:
    """Write a CRAM 3.0 subset container holding the FLAG column (see
    module docstring for the exact subset). Returns the record count.

    Containers are independent, so they are encoded and compressed on a
    pool of os.cpu_count() threads (gzip and the native rANS coder
    release the GIL) and written in order: the bytes are the JAX
    package's."""
    import concurrent.futures as cf
    import os

    flags = np.ascontiguousarray(np.asarray(flags, dtype=np.uint16)).ravel()
    starts = (list(range(0, flags.size, records_per_container))
              if flags.size else [0])

    def container(start):
        # a container's record counter is the number of its first record
        part = flags[start:start + records_per_container]
        blocks = [_compression_header_block(method), *_slice_blocks(part, start, method)]
        return _container_bytes(blocks, part.size, start)

    nt = os.cpu_count() or 1
    with open(path, "wb") as fh, cf.ThreadPoolExecutor(min(nt, len(starts))) as pool:
        fh.write(CRAM_MAGIC + b"\x00" * 20)
        # SAM header container
        hdr_text = struct.pack("<i", len(_SAM_HEADER)) + _SAM_HEADER
        hdr_block = _write_block(RAW, CT_FILE_HEADER, 0, hdr_text)
        fh.write(_container_bytes([hdr_block], 0, 0))
        # at most 2 x workers containers in flight, so memory stays
        # O(workers x container) at any file size
        pending = []
        for start in starts:
            pending.append(pool.submit(container, start))
            if len(pending) >= 2 * nt:
                fh.write(pending.pop(0).result())
        for fut in pending:
            fh.write(fut.result())
        fh.write(EOF_CONTAINER)
    return int(flags.size)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _parse_container_header(buf, off: int):
    """-> (dict, new_off) or None at a clean EOF boundary."""
    if off == len(buf):
        return None
    if off + 4 > len(buf):
        raise ValueError("container: truncated length")
    start = off
    (length,) = struct.unpack_from("<i", buf, off)
    if length < 0:
        raise ValueError("container: negative length")
    off += 4
    ref_id, off = itf8_decode(buf, off)
    al_start, off = itf8_decode(buf, off)
    al_span, off = itf8_decode(buf, off)
    n_records, off = itf8_decode(buf, off)
    counter, off = ltf8_decode(buf, off)
    bases, off = ltf8_decode(buf, off)
    n_blocks, off = itf8_decode(buf, off)
    n_land, off = itf8_decode(buf, off)
    if n_records < 0 or n_blocks < 0 or n_land < 0 or \
            n_land > len(buf) - off:
        raise ValueError("container: header counts out of bounds")
    for _ in range(n_land):
        _, off = itf8_decode(buf, off)
    if off + 4 > len(buf):
        raise ValueError("container: truncated header CRC")
    (crc,) = struct.unpack_from("<I", buf, off)
    if zlib.crc32(bytes(buf[start:off])) != crc:
        raise ValueError("container: header CRC mismatch")
    off += 4
    if length > len(buf) - off:
        raise ValueError("container: body past end of file")
    return {"len": length, "n_records": n_records, "n_blocks": n_blocks,
            "body": (off, off + length)}, off + length


def _parse_encoding_map(data: bytes):
    """compression-header content -> {series_key: external content id}.
    Raises on any BF/CF/MF series whose encoding is not EXTERNAL."""
    off = 0
    # preservation map: skip by size
    size, off = itf8_decode(data, off)
    if size < 0 or off + size > len(data):
        raise ValueError("compression header: preservation map bounds")
    off += size
    n, off, end = _read_map(data, off)
    ids = {}
    for _ in range(n):
        if off + 2 > end:
            raise ValueError("encoding map: truncated key")
        key = bytes(data[off:off + 2])
        off += 2
        codec, off = itf8_decode(data, off)
        plen, off = itf8_decode(data, off)
        if plen < 0 or off + plen > end:
            raise ValueError("encoding map: parameter bounds")
        pend = off + plen
        if key in (b"BF", b"CF", b"MF"):
            if codec != ENC_EXTERNAL:
                raise ValueError(
                    f"CRAM series {key.decode()} uses codec {codec}; "
                    "this subset reader supports EXTERNAL (1) only")
            cid, _ = itf8_decode(data, off)
            ids[key] = cid
        off = pend
    return ids


def _parse_slice_header(data: bytes):
    off = 0
    ref_id, off = itf8_decode(data, off)
    al_start, off = itf8_decode(data, off)
    al_span, off = itf8_decode(data, off)
    n_records, off = itf8_decode(data, off)
    counter, off = ltf8_decode(data, off)
    n_blocks, off = itf8_decode(data, off)
    n_ids, off = itf8_decode(data, off)
    if n_records < 0 or n_blocks < 0 or n_ids < 0 or n_ids > len(data):
        raise ValueError("slice header: counts out of bounds")
    for _ in range(n_ids):
        _, off = itf8_decode(data, off)
    return {"n_records": n_records, "n_blocks": n_blocks}


def _decode_parsed_blocks(blocks: list[dict], n_records: int) -> np.ndarray:
    """Decompressed blocks -> FLAG values. Blocks whose ``data`` is
    None were seek-skipped as not flag-bearing (full-payload CRAMs:
    seq/qual/name externals) and are ignored here."""
    if not blocks or blocks[0]["ctype"] != CT_COMPRESSION_HEADER:
        raise ValueError(
            "container: first block is not a compression header")
    ids = _parse_encoding_map(blocks[0]["data"])
    for key in (b"BF", b"CF"):
        if key not in ids:
            raise ValueError(
                f"CRAM compression header lacks the {key.decode()} "
                "series encoding")
    slice_hdrs = [b for b in blocks if b["ctype"] == CT_SLICE_HEADER]
    if not slice_hdrs:
        raise ValueError("container with records but no slice header")
    n_rec = sum(_parse_slice_header(b["data"])["n_records"]
                for b in slice_hdrs)
    if n_rec != n_records:
        raise ValueError(
            f"container/slice record count mismatch "
            f"({n_records} vs {n_rec})")
    # series blocks are per-slice; with one slice per container the
    # id->data map is unambiguous. Multi-slice containers repeat
    # ids — concatenating same-id blocks preserves record order
    # because slices are stored in order.
    ext_all: dict[int, bytes] = {}
    for b in blocks:
        if b["ctype"] == CT_EXTERNAL and b["data"] is not None:
            ext_all[b["id"]] = ext_all.get(b["id"], b"") + b["data"]
    bf_raw = ext_all.get(ids[b"BF"])
    cf_raw = ext_all.get(ids[b"CF"])
    if bf_raw is None or cf_raw is None:
        raise ValueError("BF/CF external block missing from slice")
    bf = itf8_decode_stream(bf_raw, n_rec).astype(np.int64)
    cf = itf8_decode_stream(cf_raw, n_rec).astype(np.int64)
    detached = (cf & CF_DETACHED) != 0
    downstream = ((cf & CF_MATE_DOWNSTREAM) != 0) & ~detached
    flags = bf & 0xFFFF
    need_mf = int(np.count_nonzero(detached))
    if need_mf:
        if b"MF" not in ids or ids[b"MF"] not in ext_all:
            raise ValueError("detached records but no MF series")
        mf = itf8_decode_stream(ext_all[ids[b"MF"]],
                                need_mf).astype(np.int64)
        mate_bits = ((mf & 1) << 5) | (((mf >> 1) & 1) << 3)
        add = np.zeros(n_rec, dtype=np.int64)
        add[detached] = mate_bits
        flags = flags | add
    if bool(np.count_nonzero(downstream)):
        raise ValueError(
            "CRAM slice uses within-slice mate linking (CF 0x4); "
            "mate flags live on the mate records, which this "
            "FLAG-only subset reader does not decode — refusing "
            "to miscount")
    if bool(np.any((bf < 0) | (bf > 0xFFFF))):
        raise ValueError("BF value out of FLAG range")
    return flags.astype(np.uint16)


def read_cram_flags(path, threads: int = 0) -> np.ndarray:
    """FLAG column of a CRAM 3.0 subset file -> uint16 ndarray.

    The container column reader (``lfs_cram_flags_range``,
    io/csrc/cram_columns.cpp) over the mapped file: the fused walker's
    header walk and refusals, then the containers decoded on
    ``threads`` threads (0 = one per hardware thread), each writing its
    FLAG words in place into a column sized exactly from the headers. A
    refusal raises the fused walker's ValueError (rc -2 corrupt or
    truncated, -3 outside the subset, -4 a block that does not decode).
    Where the native readers did not build: ``read_cram_flags_py``
    (``READ_ROUTE`` and a line on standard error say so)."""
    return _read_range(path, 0, None, threads, "read_cram_flags")


def read_cram_flags_py(path, threads: int = 0) -> np.ndarray:
    """FLAG column of a CRAM 3.0 subset file by the Python container
    walk: the counterpart of the JAX package's ``read_cram_flags``, and
    the route of ``read_cram_flags`` where the native readers did not
    build.

    The walk is COLUMNAR IN IO, not just in decode: unneeded blocks
    (sequences, qualities, names, tags — anything that is not the
    compression header, a slice header, or a BF/CF/MF external block)
    are skipped with `seek`, so a full-payload CRAM costs only the
    flag-bearing bytes plus per-block headers — the disk never serves
    the seq/qual blocks at all. Skipped blocks' CRCs are necessarily
    unverified (verifying would mean reading them); every block that
    IS read stays fully CRC/bounds-gated.

    Containers are independent, so their series decode on a thread
    pool (``threads``: 0 = os.cpu_count(), 1 = serial); the header
    walk that finds them is sequential and cheap. rANS blocks decode
    natively when the readers built, else in Python. Refusals raise
    ValueError with the reason in words."""
    return _read_range_py(path, 0, None, threads)


def _read_range(path, start: int, stop: int | None, threads: int,
                what: str) -> np.ndarray:
    """FLAG column of data containers [start, stop) (stop None: to the
    end): the container column reader where the native readers built,
    else the Python walk, said on standard error; ``what`` names the
    caller in the route line."""
    global READ_ROUTE
    lib = native_lib.column_route()
    READ_ROUTE = "python" if lib is None else "native"
    if lib is None:
        native_lib.python_route(what)
        return _read_range_py(path, start, stop, threads)
    import ctypes
    import os

    size = os.path.getsize(path)
    # an empty file has no mapping; the reader refuses it as too short
    mm = (native_lib.map_sequential(path, willneed=False) if size
          else np.zeros(1, dtype=np.uint8))
    hi = -1 if stop is None else stop
    n = lib.lfs_cram_range_records(mm.ctypes.data, size, start, hi, None)
    if n < 0:
        raise ValueError(_refusal("lfs_cram_range_records", n))
    out = np.empty(n, dtype=np.uint16)
    n_out = ctypes.c_int64(0)
    rc = lib.lfs_cram_flags_range(mm.ctypes.data, size, start, hi,
                                  out.ctypes.data_as(ctypes.c_void_p), n, threads,
                                  ctypes.byref(n_out))
    if rc != 0:
        raise ValueError(_refusal("lfs_cram_flags_range", rc))
    if n_out.value != n:
        raise ValueError("CRAM file changed while it was read")
    return out


def _read_range_py(path, start: int, stop: int | None, threads: int) -> np.ndarray:
    """FLAG column of data containers [start, stop) (stop None: to the
    end) by the seek-only walk, containers decoded on a thread pool."""
    with open(path, "rb") as fh:
        jobs: list[tuple] = []         # (needed_blocks, n_records)
        for idx, (hdr, body_off) in enumerate(_iter_data_containers(fh)):
            if idx < start:
                continue
            if stop is not None and idx >= stop:
                break
            fh.seek(body_off)
            jobs.append((_collect_needed_blocks(
                fh, hdr["n_blocks"], body_off + hdr["len"]),
                hdr["n_records"]))
    if not jobs:
        return np.zeros(0, dtype=np.uint16)
    if threads == 1 or len(jobs) == 1:
        out = [_decode_container_job(*j) for j in jobs]
    else:
        import concurrent.futures as cf
        import os as _os

        nt = threads if threads > 0 else (_os.cpu_count() or 1)
        with cf.ThreadPoolExecutor(min(nt, len(jobs))) as pool:
            out = list(pool.map(lambda j: _decode_container_job(*j),
                                jobs))
    return np.concatenate(out)


def _iter_data_containers(fh):
    """Walk a CRAM file's container headers (seek-only — no block data
    is read), yielding (header_dict, body_offset) for each DATA
    container in file order. Validates the magic/version, the
    SAM-header first container, and every container-header CRC; leaves
    the file position unspecified between yields (callers seek)."""
    fh.seek(0)
    head = fh.read(26)
    if len(head) < 26 or head[:4] != b"CRAM":
        raise ValueError("not a CRAM file")
    if head[4:6] != b"\x03\x00":
        raise ValueError(
            f"CRAM version {head[4]}.{head[5]} unsupported (3.0 only)")
    first = True
    while True:
        hdr = _read_container_header_fh(fh)
        if hdr is None:
            return                     # clean EOF
        body_off = fh.tell()
        end = body_off + hdr["len"]
        if first:
            first = False
            blk = _read_block_fh(fh, want_data=False)
            if blk["ctype"] == CT_FILE_HEADER:
                fh.seek(end)
                continue
            raise ValueError(
                "CRAM: first container is not a SAM-header container")
        if hdr["n_records"] == 0:
            fh.seek(end)               # EOF container or empty — skip
            continue
        yield hdr, body_off
        fh.seek(end)


def data_container_count(path) -> int:
    """Number of data containers (the multihost shard unit) — a
    header-only walk, a few dozen bytes read per container."""
    with open(path, "rb") as fh:
        return sum(1 for _ in _iter_data_containers(fh))


def _fused(symbol: str, path, threads: int, *ranges: int) -> np.ndarray | None:
    """One fused CRAM walk+count of the readers over the mapped file,
    ``symbol(data, n_bytes, *ranges, counters, threads, n_records_out)``
    (the CRAM walkers' argument order, not the BAM and SAM walkers').
    Returns the counters, or None for an empty file. A negative rc
    raises ValueError: a CF 0x4 slice, rANS order-1, a CRC, size or
    record-count mismatch, truncation; the walker never guesses."""
    import ctypes
    import os

    lib = native_lib.readers()
    size = os.path.getsize(path)
    if size == 0:
        return None
    # willneed=False: the walk touches only the flag-bearing pages;
    # prefetching a full-payload file would pay cold IO for bytes never
    # read
    mm = native_lib.map_sequential(path, willneed=False)
    counters = np.zeros(32, dtype=np.uint64)
    n_out = ctypes.c_int64(0)
    rc = getattr(lib, symbol)(mm.ctypes.data, size, *ranges,
                              counters.ctypes.data_as(ctypes.c_void_p), threads,
                              ctypes.byref(n_out))
    if rc == 0:
        return counters
    raise ValueError(_refusal(symbol, rc))


def _refusal(symbol: str, rc: int) -> str:
    """The message of a native CRAM walker's or reader's negative rc."""
    return (f"{symbol} failed (rc={rc}) — corrupt, truncated, or outside the "
            "documented CRAM subset")


def flagstat_cram_range(path, start: int, stop: int, threads: int = 0,
                        impl: str | None = None, device=None) -> np.ndarray:
    """32-counter vector over data containers [start, stop) — the
    multihost shard leg (parallel/multihost.flagstat_multihost_cram):
    containers are independent, so P processes each counting a
    contiguous container range sum exactly (the block-accumulative
    contract; counter 9 derives per chunk inside flagstats_u16).

    Routed as ``flagstat_cram``: ``impl=None`` reads the range's column
    (the container column reader, or the Python walk where the native
    readers did not build) and counts it on the card (``device="cpu"``:
    the torch tier on the CPU; no card and no ``device``: raises before
    reading); any other
    ``impl`` counts the read column with that tier; ``impl="native"``
    takes the fused range walker (lfs_cram_flagstat_range), which
    raises when the readers did not build."""
    from ..ops import dispatch as D

    if impl == "native":
        counters = _fused("lfs_cram_flagstat_range", path, threads, start, stop)
        if counters is not None:
            return counters
    elif impl is None:
        D.device_impl(device)   # no card and no device: raise before reading
    return D.flagstats_u16(_read_range(path, start, stop, threads, "flagstat_cram_range"),
                           impl=impl, device=device)


def _read_exact(fh, n: int) -> bytes:
    data = fh.read(n)
    if len(data) != n:
        raise ValueError("CRAM: truncated file")
    return data


def _read_container_header_fh(fh):
    """Container header via incremental reads (CRC-checked); None at a
    clean end of file or the canonical/structural EOF container."""
    raw = fh.read(4)
    if not raw:
        return None
    if len(raw) < 4:
        raise ValueError("container: truncated length")
    acc = bytearray(raw)
    (length,) = struct.unpack("<i", raw)
    if length < 0:
        raise ValueError("container: negative length")

    def take(n):
        b = _read_exact(fh, n)
        acc.extend(b)
        return b

    def itf8():
        b0 = take(1)[0]
        extra = 0 if b0 < 0x80 else 1 if b0 < 0xC0 else \
            2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
        rest = take(extra) if extra else b""
        v, _ = itf8_decode(bytes([b0]) + rest, 0)
        return v

    def ltf8():
        b0 = take(1)[0]
        extra, mask = 0, 0x80
        while extra < 8 and (b0 & mask):
            extra += 1
            mask >>= 1
        rest = take(extra) if extra else b""
        v, _ = ltf8_decode(bytes([b0]) + rest, 0)
        return v

    itf8()                             # ref seq id
    itf8()                             # start
    itf8()                             # span
    n_records = itf8()
    ltf8()                             # record counter
    ltf8()                             # bases
    n_blocks = itf8()
    n_land = itf8()
    if n_records < 0 or n_blocks < 0 or n_land < 0 or n_land > length:
        raise ValueError("container: header counts out of bounds")
    for _ in range(n_land):
        itf8()
    (crc,) = struct.unpack("<I", _read_exact(fh, 4))
    if zlib.crc32(bytes(acc)) != crc:
        raise ValueError("container: header CRC mismatch")
    return {"len": length, "n_records": n_records, "n_blocks": n_blocks}


def _read_block_fh(fh, want_data: bool = True):
    """One block via incremental reads. ``want_data=False`` seeks past
    the payload+CRC (the columnar skip — those bytes never leave the
    disk); otherwise the payload is read raw (decompression deferred
    to the decode pool) and the CRC is verified."""
    acc = bytearray(_read_exact(fh, 2))
    method, ctype = acc[0], acc[1]

    def itf8():
        b0 = fh.read(1)
        if not b0:
            raise ValueError("block: truncated header")
        acc.extend(b0)
        b0 = b0[0]
        extra = 0 if b0 < 0x80 else 1 if b0 < 0xC0 else \
            2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
        rest = _read_exact(fh, extra) if extra else b""
        acc.extend(rest)
        v, _ = itf8_decode(bytes([b0]) + rest, 0)
        return v

    content_id = itf8()
    comp_size = itf8()
    raw_size = itf8()
    if comp_size < 0 or raw_size < 0:
        raise ValueError("block: negative size")
    if not want_data:
        fh.seek(comp_size + 4, 1)
        return {"method": method, "ctype": ctype, "id": content_id,
                "comp": None, "raw_size": raw_size}
    comp = _read_exact(fh, comp_size)
    (crc,) = struct.unpack("<I", _read_exact(fh, 4))
    if zlib.crc32(bytes(acc) + comp) != crc:
        raise ValueError("block: CRC mismatch")
    return {"method": method, "ctype": ctype, "id": content_id,
            "comp": comp, "raw_size": raw_size}


def _collect_needed_blocks(fh, n_blocks: int, end: int) -> list[dict]:
    """Walk a data container's blocks, reading only what flag
    reconstruction needs and seeking past the rest. The compression
    header (always block 0) yields the BF/CF/MF content ids that
    decide which external blocks to read."""
    if n_blocks < 1:
        raise ValueError("container with records but no blocks")
    blocks = []
    first = _read_block_fh(fh, want_data=True)
    if fh.tell() > end:
        # every block must stay inside the container's declared length —
        # the same "compressed size past container end" gate the
        # in-memory _read_block applies; without it a crafted block
        # could bleed into the next container's bytes
        raise ValueError("block: compressed size past container end")
    if first["ctype"] != CT_COMPRESSION_HEADER:
        raise ValueError(
            "container: first block is not a compression header")
    blocks.append(first)
    ids = _parse_encoding_map(
        _decompress_payload(first["method"], first["comp"],
                            first["raw_size"]))
    needed_ids = set(ids.values())
    for _ in range(n_blocks - 1):
        if fh.tell() >= end:
            raise ValueError("container: blocks run past declared length")
        pos = fh.tell()
        blk = _read_block_fh(fh, want_data=False)
        if fh.tell() > end:
            raise ValueError("block: compressed size past container end")
        want = (blk["ctype"] == CT_SLICE_HEADER
                or (blk["ctype"] == CT_EXTERNAL
                    and blk["id"] in needed_ids))
        if want:
            fh.seek(pos)
            blk = _read_block_fh(fh, want_data=True)
        blocks.append(blk)
    return blocks


def _decompress_payload(method: int, comp: bytes, raw_size: int) -> bytes:
    if method == RAW:
        data = comp
    elif method == GZIP:
        try:
            data = zlib.decompress(comp, wbits=31)
        except zlib.error as e:
            raise ValueError(f"block: bad gzip stream ({e})") from None
    elif method == RANS:
        data = _rans_decompress(comp, raw_size)
    else:
        raise ValueError(
            f"block: compression method {method} not supported by the "
            "CRAM subset reader (raw/gzip/rans4x8)")
    if len(data) != raw_size:
        raise ValueError(
            f"block: raw size mismatch (declared {raw_size}, got "
            f"{len(data)})")
    return data


def _decode_container_job(blocks: list[dict], n_records: int) -> np.ndarray:
    """Deferred (pool-side) half of the walk: decompress the collected
    blocks, then _decode_parsed_blocks reconstructs the FLAGs."""
    parsed = []
    for b in blocks:
        data = (_decompress_payload(b["method"], b["comp"], b["raw_size"])
                if b["comp"] is not None else None)
        parsed.append({"ctype": b["ctype"], "id": b["id"], "data": data})
    return _decode_parsed_blocks(parsed, n_records)


def flagstat_cram(path, threads: int = 0, impl: str | None = None, device=None):
    """`samtools flagstat <file.cram>` with no samtools in the loop.

    ``impl=None`` reads the column with ``read_cram_flags`` and counts
    it on the card (``device="cpu"``: the torch tier on the CPU; no card
    and no ``device``: raises before reading). Any other ``impl`` of
    ``ops.dispatch.FLAGSTAT_IMPLS`` counts the read column with that
    tier. ``impl="native"`` takes the fused host walker instead
    (cram_reader.cpp: container parse, needed-block decode, FLAG
    reconstruction and the accumulating host count, threaded over
    containers; the column never materializes whole); it raises when
    the readers did not build, and with the Python reader's refusals
    when the file is outside the subset (both raise, neither guesses)."""
    from ..ops import dispatch as D

    if impl == "native":
        counters = _fused("lfs_cram_flagstat", path, threads)
        if counters is not None:
            return counters
    elif impl is None:
        D.device_impl(device)   # no card and no device: raise before reading
    return D.flagstats_u16(read_cram_flags(path, threads=threads), impl=impl, device=device)

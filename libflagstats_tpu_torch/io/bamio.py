"""BAM/BGZF ingest: the port of ``libflagstats_tpu.io.bamio``.

It extracts the FLAG column straight from a .bam file, so `flagstat
file.bam` needs no samtools upstream (the reference library consumes a
pre-extracted binary column: `samtools view | cut -f2 | utility`,
reference README.md:56).

Format facts used (SAM/BAM spec v1.6):
- BGZF = concatenated gzip members, each with an extra subfield
  'BC' carrying BSIZE (total member size - 1); member payload is raw
  DEFLATE of <= 65536 bytes; the stream ends with a fixed 28-byte EOF
  member.
- BAM payload: magic "BAM\\1", l_text, text, n_ref, n_ref x
  {l_name, name, l_ref}, then alignment records of
  {block_size:int32, ...}: FLAG is the uint16 at byte offset 14 inside
  the record body (refID 4 + pos 4 + l_read_name 1 + mapq 1 + bin 2 +
  n_cigar_op 2).

The pure-Python reader here is the correctness reference, and the
route where the native readers did not build (``READ_ROUTE`` says which
one the last read took; the Python route says so on standard error).
The native walker (the port's copy of bam_reader.cpp, io/native_lib.py
``load_readers()``) inflates BGZF members on a thread pool and walks the
records in order; the range column reader (the port's own
flag_columns.cpp, ``load_columns()``) reads the column of one
inflated-byte range, for the multihost leg. The writer makes
spec-conform files for tests and synthetic runs: minimal records
(l_seq = 0) or 151 bp HiSeqX-weight ones.

Counting differs from the JAX package on purpose: ``flagstat_bam``
reads the column and counts it on the card (``impl=None``), on the CPU
(``device="cpu"``) or with any tier named by ``impl``; the fused host
walk+count runs only when ``impl="native"`` names it.
"""
from __future__ import annotations

import gzip
import os
import struct
import zlib

import numpy as np

from . import native_lib

#: "native" or "python": the reader the last read_bam_flags call took
READ_ROUTE: str | None = None

#: fixed BGZF end-of-file member (SAM spec 4.1.2)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_FIXED = 32          # record bytes after block_size, before read_name
_FLAG_OFF = 14       # offset of the uint16 FLAG inside the record body


def _bgzf_member(payload: bytes, level: int = 6) -> bytes:
    """One BGZF member (gzip + BC/BSIZE extra subfield) for <= 64KiB."""
    assert len(payload) <= 65536
    co = zlib.compressobj(level, zlib.DEFLATED, -15)  # raw deflate
    comp = co.compress(payload) + co.flush()
    bsize = 12 + 6 + len(comp) + 8  # header(12+xtra 6) + data + footer(8)
    if bsize > 65536:
        # incompressible payload: store nearly raw (level 0)
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        bsize = 12 + 6 + len(comp) + 8
    head = struct.pack("<BBBBIBBHBBHH",
                       0x1F, 0x8B, 8, 4,    # gzip magic, deflate, FEXTRA
                       0, 0, 0xFF,          # mtime, xfl, os
                       6,                   # XLEN
                       ord("B"), ord("C"), 2, bsize - 1)
    foot = struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)
    return head + comp + foot


#: realistic-payload synthesis constants: the reference's workload is
#: the real NA12878 HiSeqX BAM (reference README.md:33,54-63), whose
#: records carry ~151bp SEQ/QUAL + names + aux — ~10x the inflate bytes
#: of a flags-only record. These shapes reproduce that record weight
#: spec-conformly.
READ_LEN = 151
_RNAME_PREFIX = b"ST-E00118:53:H02GVALXX:1:1101:"   # + 5 + 1 + 7 digits
#: Illumina RTA2 quality binning (approximate published distribution)
_QUAL_BINS = np.array([2, 12, 23, 37], dtype=np.uint8)
_QUAL_P = np.array([0.02, 0.05, 0.12, 0.81])
_SEQ_CODES = np.array([1, 2, 4, 8], dtype=np.uint8)   # A,C,G,T 4-bit codes
#: byte -> binned-qual LUT (256 entries weighted to _QUAL_P)
_QUAL_LUT = np.repeat(_QUAL_BINS,
                      np.round(_QUAL_P * 256).astype(int))[:256]
#: byte -> two packed 4-bit base codes (bits 0-1 and 2-3 pick the bases)
_SEQ_PAIR_LUT = ((_SEQ_CODES[np.arange(256) & 3] << 4)
                 | _SEQ_CODES[(np.arange(256) >> 2) & 3]).astype(np.uint8)

#: realistic-record aux block (RG:Z: + AS:i: + YT:Z:), shared by the
#: template builder and the length derivation below
_REALISTIC_AUX = (b"RGZ" + b"NA12878L1\x00"
                  + b"ASi" + struct.pack("<i", 0)
                  + b"YTZ" + b"UU\x00")
_REALISTIC_NAME_LEN = len(_RNAME_PREFIX) + 5 + 1 + 7 + 1      # + NUL
#: full on-disk record length (4-byte block_size + body) of one
#: realistic record — DERIVED from the same arithmetic that builds the
#: _realistic_chunk template, so chunk sizing can never silently drift
#: from the actual record shape
REALISTIC_REC_LEN = (4 + _FIXED + _REALISTIC_NAME_LEN
                     + (READ_LEN + 1) // 2 + READ_LEN + len(_REALISTIC_AUX))


def _realistic_chunk(part: np.ndarray, start: int, seed: int) -> bytes:
    """Vectorized (n, rec_len) realistic BAM records for FLAG chunk
    ``part``: 44-byte Illumina-style name, 151bp packed SEQ (random
    ACGT), 151 binned QUAL bytes, RG/AS/YT aux — unmapped-style
    coordinates so only FLAG semantics matter, like the minimal writer."""
    n = part.size
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(start))
    name_len = _REALISTIC_NAME_LEN
    seq_bytes = (READ_LEN + 1) // 2
    aux = _REALISTIC_AUX
    body_len = _FIXED + name_len + seq_bytes + READ_LEN + len(aux)
    template = (struct.pack("<i", body_len)
                + struct.pack("<iiBBHH", -1, -1, name_len, 0, 4680, 0)
                + b"\x00\x00"                              # FLAG placeholder
                + struct.pack("<iiii", READ_LEN, -1, -1, 0)
                + _RNAME_PREFIX + b"0" * 5 + b":" + b"0" * 7 + b"\x00"
                + b"\x00" * (seq_bytes + READ_LEN)
                + aux)
    rec_len = len(template)
    assert rec_len == REALISTIC_REC_LEN, (rec_len, REALISTIC_REC_LEN)
    recs = np.broadcast_to(
        np.frombuffer(template, dtype=np.uint8), (n, rec_len)).copy()
    recs[:, 18:20] = part.view(np.uint8).reshape(-1, 2)
    # name counter digits: tile = idx // 1e7 (5 wide), x = idx % 1e7 (7)
    idx = np.arange(start, start + n, dtype=np.int64)
    dig0 = 36 + len(_RNAME_PREFIX)
    for w, base, val in ((5, dig0, idx // 10_000_000),
                         (7, dig0 + 6, idx % 10_000_000)):
        for d in range(w):
            recs[:, base + d] = (val // 10 ** (w - 1 - d)) % 10 + ord("0")
    # SEQ: random ACGT, two 4-bit codes per byte — one raw-bytes draw +
    # a 256-entry packed-pair LUT (rng.choice/bounded-integers were the
    # profile hotspot at multi-hundred-Mrecord scale)
    rb = np.frombuffer(rng.bytes(n * seq_bytes), dtype=np.uint8)
    seq0 = dig0 + 14
    recs[:, seq0:seq0 + seq_bytes] = _SEQ_PAIR_LUT[rb].reshape(n, seq_bytes)
    # QUAL: RTA-binned phred values (low-entropy, like real HiSeqX),
    # via a byte->bin LUT weighted to the published distribution
    q0 = seq0 + seq_bytes
    qb = np.frombuffer(rng.bytes(n * READ_LEN), dtype=np.uint8)
    recs[:, q0:q0 + READ_LEN] = _QUAL_LUT[qb].reshape(n, READ_LEN)
    return recs.tobytes()


def write_bam(path, flags, read_name: bytes = b"r",
              block_bytes: int = 60000, level: int = 6,
              payload: str = "minimal", seed: int = 0,
              threads: int = 4) -> int:
    """Write a spec-conform BAM whose records carry the given FLAG
    values. ``payload="minimal"``: no sequence/quality/cigar (l_seq = 0
    is spec-legal) — the per-record fixed overhead the FLAG walk has to
    skip. ``payload="realistic"``: 151bp HiSeqX-weight records
    (_realistic_chunk) matching the reference workload's ~10x inflate
    bytes. Record assembly is numpy-vectorized and BGZF members deflate
    on a thread pool (zlib releases the GIL), else multi-hundred-Mrecord
    synthetic benchmarks are impractical. Returns the record count."""
    import concurrent.futures as cf

    flags = np.ascontiguousarray(np.asarray(flags, dtype=np.uint16)).ravel()
    name = read_name + b"\x00"
    header = b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 0)
    template = (struct.pack("<i", _FIXED + len(name))
                + struct.pack("<iiBBHH", -1, -1, len(name), 0, 4680, 0)
                + b"\x00\x00"                       # FLAG placeholder
                + struct.pack("<iiii", 0, -1, -1, 0)
                + name)
    rec_len = len(template) if payload == "minimal" else REALISTIC_REC_LEN
    chunk_records = max(1, (1 << 24) // rec_len)    # ~16 MB of raw records

    with open(path, "wb") as fh, cf.ThreadPoolExecutor(threads) as pool:
        buf = bytearray(header)

        def flush(final: bool = False):
            blocks = []
            while len(buf) >= block_bytes or (final and buf):
                blocks.append(bytes(buf[:block_bytes]))
                del buf[:block_bytes]
            for member in pool.map(
                    lambda b: _bgzf_member(b, level=level), blocks):
                fh.write(member)

        for start in range(0, flags.size, chunk_records):
            part = flags[start:start + chunk_records]
            if payload == "realistic":
                buf += _realistic_chunk(part, start, seed)
            else:
                recs = np.broadcast_to(
                    np.frombuffer(template, dtype=np.uint8),
                    (part.size, len(template))).copy()
                recs[:, 18:20] = part.view(np.uint8).reshape(-1, 2)
                buf += recs.tobytes()
            flush()
        flush(final=True)
        fh.write(BGZF_EOF)
    return int(flags.size)


def read_bam_flags_py(path, max_records: int | None = None) -> np.ndarray:
    """Pure-Python FLAG-column extraction from a BAM (the correctness
    reference for the native walker). Streams the decompressed payload;
    memory stays O(block)."""
    flags: list[int] = []
    with gzip.open(path, "rb") as fh:
        magic = fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"not a BAM file (magic {magic!r})")
        (l_text,) = struct.unpack("<i", fh.read(4))
        fh.read(l_text)
        (n_ref,) = struct.unpack("<i", fh.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", fh.read(4))
            fh.read(l_name + 4)
        while True:
            bs = fh.read(4)
            if len(bs) < 4:
                break
            (block_size,) = struct.unpack("<i", bs)
            if block_size < _FIXED:
                raise ValueError(f"corrupt record (block_size {block_size})")
            body = fh.read(block_size)
            if len(body) < block_size:
                raise ValueError("truncated BAM record")
            flags.append(struct.unpack_from("<H", body, _FLAG_OFF)[0])
            if max_records is not None and len(flags) >= max_records:
                break
    return np.asarray(flags, dtype=np.uint16)


def read_bam_flags(path, threads: int = 0) -> np.ndarray:
    """FLAG column of a BAM file -> uint16 array.

    The native threaded walker when the readers built (BGZF members
    inflate in parallel, records walk in order with cross-member carry),
    else the Python reader (``READ_ROUTE`` and a line on standard error
    say so)."""
    import ctypes

    global READ_ROUTE
    lib = native_lib.load_readers()
    READ_ROUTE = "python" if lib is None else "native"
    if lib is None:
        native_lib.python_route("read_bam_flags")
        return read_bam_flags_py(path)
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError("empty BAM file")
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    addr = mm.ctypes.data
    bound = lib.lfs_bam_bound(addr, size)
    if bound < 0:
        raise ValueError(f"BAM parse failed (rc={bound}) — file "
                         "corrupt, truncated, or not BGZF")
    out = np.empty(bound, dtype=np.uint16)
    got = lib.lfs_bam_flags(
        addr, size, out.ctypes.data_as(ctypes.c_void_p), bound, threads)
    if got < 0:
        raise ValueError(f"BAM walk failed (rc={got}) — file "
                         "corrupt, truncated, or not BGZF")
    return out[:got].copy()


def bam_raw_size(path) -> int:
    """Total inflated byte size of a BGZF chain (header-only scan) —
    the shard space for multi-host BAM byte-range counting. Raises
    RuntimeError when the readers did not build."""
    lib = native_lib.readers()
    size = os.path.getsize(path)
    if size == 0:
        return 0
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    n = lib.lfs_bgzf_raw_size(mm.ctypes.data, size)
    if n < 0:
        raise ValueError(f"BGZF scan failed (rc={n})")
    return int(n)


def flagstat_bam_byte_range(path, byte_lo: int, byte_hi: int,
                            threads: int = 0):
    """Fused flagstat over one inflated-byte range of a BAM — the
    multi-host shard unit. The range is entered by arrival-exact resync
    (bam_reader.cpp): the walk starts at the first structurally
    validated record boundary >= byte_lo (the authoritative header end
    when byte_lo <= it) and ends at the first boundary >= byte_hi; the
    caller MUST verify that the (start, end) endpoints chain exactly
    across shards before trusting the counts. Returns
    (counters uint64[32], n_records, start, end), or None when the
    range could not be entered (resync failure) — the caller falls
    back to a sequential count."""
    import ctypes

    from .. import flags as F

    lib = native_lib.readers()
    size = os.path.getsize(path)
    counters = np.zeros(F.N_COUNTERS, dtype=np.uint64)
    if size == 0:
        return counters, 0, 0, 0
    mm = native_lib.map_sequential(path)
    start = ctypes.c_int64(-1)
    end = ctypes.c_int64(-1)
    got = lib.lfs_bam_flagstat_byte_range(
        mm.ctypes.data, size, byte_lo, byte_hi,
        counters.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(start), ctypes.byref(end), threads, 0)
    if got == -9:
        return None
    if got < 0:
        raise ValueError(f"BAM byte-range count failed (rc={got})")
    return counters, int(got), int(start.value), int(end.value)


def read_bam_flags_byte_range(path, byte_lo: int, byte_hi: int, threads: int = 0):
    """FLAG column of one inflated-byte range of a BAM: the column twin
    of ``flagstat_bam_byte_range`` (the range column reader
    ``lfs_bam_flags_byte_range``, io/csrc/flag_columns.cpp), entered and
    ended by the same arrival-exact resync walk. Returns (column uint16,
    start, end), where (start, end) equal ``flagstat_bam_byte_range``'s
    and the caller MUST check that they chain across ranges; or None
    when the range could not be entered. The columns of ranges whose
    endpoints chain concatenate to the file's column. Raises
    RuntimeError when the range column readers did not build: there is
    no host fallback."""
    import ctypes

    lib = native_lib.columns()
    size = os.path.getsize(path)
    if size == 0:
        return np.zeros(0, dtype=np.uint16), 0, 0
    mm = native_lib.map_sequential(path)
    cap = lib.lfs_bam_flags_range_bound(mm.ctypes.data, size, byte_lo, byte_hi)
    if cap < 0:
        raise ValueError(f"BAM byte-range read failed (rc={cap})")
    out = np.empty(cap, dtype=np.uint16)
    start = ctypes.c_int64(-1)
    end = ctypes.c_int64(-1)
    got = lib.lfs_bam_flags_byte_range(
        mm.ctypes.data, size, byte_lo, byte_hi, out.ctypes.data_as(ctypes.c_void_p), cap,
        ctypes.byref(start), ctypes.byref(end), threads)
    if got == -9:
        return None
    if got < 0:
        raise ValueError(f"BAM byte-range read failed (rc={got})")
    return out[:got], int(start.value), int(end.value)


def flagstat_bam(path, threads: int = 0, impl: str | None = None, device=None):
    """samtools-flagstat counters straight from a BAM file.

    ``impl=None`` reads the column with the native walker and counts it
    on the card (``device="cpu"``: the torch tier on the CPU; no card and
    no ``device``: raises before reading). Any other ``impl`` of
    ``ops.dispatch.FLAGSTAT_IMPLS`` counts the read column with that
    tier. ``impl="native"`` takes the fused host walk+count instead
    (``lfs_bam_flagstat_parallel``, range-parallel and chain-verified):
    the column never materializes; it raises when the readers did not
    build."""
    from ..ops import dispatch as D

    if impl == "native":
        counters = native_lib.fused_flagstat("lfs_bam_flagstat_parallel", path, threads)
        if counters is not None:
            return counters
    elif impl is None:
        D.device_impl(device)   # no card and no device: raise before reading
    return D.flagstats_u16(read_bam_flags(path, threads=threads), impl=impl, device=device)

"""ctypes loader for the native host libraries (C++, built at first use).

The port builds its own copies of the JAX package's C++ host sources,
kept in ``io/csrc/`` byte for byte equal to ``libflagstats_tpu/io/native/``
(tests/test_torch_native_sources.py), into shared objects of their own:

* the host library (``load()``): ``flagstats_io.cpp`` (the framed LZ4
  and Zstd block codecs, the parallel framed-stream decoder, the fused
  framed decode+count, the AVX2 host bit transpose and the CRAM itf8
  stream decoder) and
  ``flagstats_host.cpp`` (the AVX2 host flagstat and pospopcnt kernels
  and the POPCNT set-algebra counts);
* the readers (``load_readers()``): ``bam_reader.cpp`` and
  ``sam_reader.cpp`` (the BGZF member walkers, the BAM record walk and
  the SAM text parser, column and fused walk+count), ``rans4x8.cpp``
  (the CRAM rANS-4x8 order-0 codec) and ``cram_reader.cpp`` (the fused
  CRAM container walk+count, which inflates gzip blocks through
  ``bgzf.h`` and rANS blocks through ``rans4x8.cpp``), with their shared
  ``bgzf.h`` and a second copy of ``flagstats_host.cpp``, whose
  ``lfs_flagstat_u16`` the fused walkers call. A host without zlib or
  libdeflate so never loses the codec library;
* the perf counters (``load_perf()``): ``perf_events.cpp``, the
  ``perf_event_open`` counter groups that ``bench/perf_native.py``
  reads. It includes ``<linux/perf_event.h>``, so an image without that
  header loses the counters and nothing else;
* the column readers (``load_columns()``): the port's own files
  ``flag_columns.cpp``, which writes the FLAG column of a BAM
  inflated-byte range or of a BGZF SAM member range, and
  ``cram_columns.cpp``, which writes that of a range of CRAM data
  containers (the column twins of the readers' fused range walkers).
  They include the copies of ``bam_reader.cpp`` and ``sam_reader.cpp``,
  and of ``cram_reader.cpp``, to reach their internal machinery, so
  they redefine the copies' symbols and build into an object of their
  own, with copies of ``rans4x8.cpp`` and ``flagstats_host.cpp`` that
  the included walkers call.

g++ builds each into ``build/torch_host/``, keyed on a hash of the
sources, the flags and the host tag, through a temp file and a rename,
so a concurrent build never loads a half-written file. A loader
returns None when its build fails and keeps the compiler's message in
``BUILD_ERROR`` / ``READERS_BUILD_ERROR`` / ``PERF_BUILD_ERROR`` /
``COLUMNS_BUILD_ERROR``:
callers that must not fall back raise with it.

Missing headers: where the system ``<zstd.h>`` compiles and ``-lzstd``
links, the build uses them ("system"); otherwise it takes the
declarations in ``io/csrc/compat/zstd.h`` and links the runtime
``libzstd.so.1`` ("compat"). The readers link zlib (``-lz``).
libdeflate, which inflates BGZF members faster than zlib, is linked
where a probe compiles and links it ("libdeflate"), else the readers
inflate with zlib ("zlib", ``-DLFS_NO_LIBDEFLATE``); the range column
readers take the same route. ``ZSTD_ROUTE``
and ``DEFLATE_ROUTE`` say what the last build probes chose.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
SOURCES = (CSRC / "flagstats_io.cpp", CSRC / "flagstats_host.cpp")
READER_SOURCES = (CSRC / "bam_reader.cpp", CSRC / "sam_reader.cpp", CSRC / "rans4x8.cpp",
                  CSRC / "cram_reader.cpp", CSRC / "flagstats_host.cpp")
#: the readers' one local include (hashed into their build key)
READER_HEADERS = (CSRC / "bgzf.h",)
PERF_SOURCES = (CSRC / "perf_events.cpp",)
COLUMNS_SOURCES = (CSRC / "flag_columns.cpp", CSRC / "cram_columns.cpp", CSRC / "rans4x8.cpp",
                   CSRC / "flagstats_host.cpp")
#: what flag_columns.cpp and cram_columns.cpp include (hashed into their build key)
COLUMNS_HEADERS = (CSRC / "bam_reader.cpp", CSRC / "sam_reader.cpp", CSRC / "cram_reader.cpp",
                   CSRC / "bgzf.h")
COMPAT_DIR = CSRC / "compat"
BUILD_DIR = _HERE.parent.parent / "build" / "torch_host"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread", "-Wl,--no-undefined")
# -march=native binaries are host-specific: a library built by an
# AVX-512 host must not be loaded by an older-ISA host sharing the
# checkout (SIGILL), so the key carries a per-host tag
_HOST_TAG = f"{platform.node()}|{platform.machine()}"

_ZSTD_PROBE = ("#include <zstd.h>\n"
               "int main() { return ZSTD_compressBound(1) == 0; }\n")
_DEFLATE_PROBE = ("#include <libdeflate.h>\n"
                  "int main() { return libdeflate_alloc_decompressor() == nullptr; }\n")

#: "system" or "compat": how the last build probe found libzstd
ZSTD_ROUTE: str | None = None
#: "libdeflate" or "zlib": what the last readers' build inflates with
DEFLATE_ROUTE: str | None = None
#: why the last ``load()`` returned None ("" until one did)
BUILD_ERROR = ""
#: why the last ``load_readers()`` returned None ("" until one did)
READERS_BUILD_ERROR = ""
#: why the last ``load_perf()`` returned None ("" until one did)
PERF_BUILD_ERROR = ""
#: why the last ``load_columns()`` returned None ("" until one did)
COLUMNS_BUILD_ERROR = ""

_lib = None
_readers = None
_perf = None
_columns = None
_lock = threading.Lock()
_readers_lock = threading.Lock()
_perf_lock = threading.Lock()
_columns_lock = threading.Lock()


def _links(probe: str, libs: list[str]) -> bool:
    """Whether ``probe`` compiles and links with ``libs``, with the
    compiler the build uses."""
    try:
        r = subprocess.run(["g++", "-x", "c++", "-", *libs, "-o", os.devnull],
                           input=probe, text=True, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return r.returncode == 0


def _zstd_flags() -> tuple[str, list[str], list[str]]:
    """The zstd route, its include flags and its link flags."""
    if _links(_ZSTD_PROBE, ["-lzstd"]):
        return "system", [], ["-lzstd"]
    return "compat", ["-I", str(COMPAT_DIR)], ["-l:libzstd.so.1"]


def _deflate_flags() -> tuple[str, list[str], list[str]]:
    """The inflate route, its compile flags and its link flags. bgzf.h
    takes libdeflate wherever ``__has_include`` finds its header, so the
    zlib route must say ``-DLFS_NO_LIBDEFLATE``: header and link line
    then always agree."""
    if _links(_DEFLATE_PROBE, ["-ldeflate"]):
        return "libdeflate", [], ["-ldeflate"]
    return "zlib", ["-DLFS_NO_LIBDEFLATE"], []


def _compile(stem: str, sources, headers, inc: list[str], libs: list[str]) -> Path:
    """Compile ``sources`` into ``BUILD_DIR/<stem>_<key>.so`` unless that
    file exists; the key hashes the sources, ``headers``, the flags and
    the host. Raises, with the compiler's stderr, when the build fails."""
    key = hashlib.sha256()
    for p in (*sources, *headers):
        key.update(p.name.encode() + b"\0" + p.read_bytes())
    key.update(" ".join([*CXX_FLAGS, *inc, *libs]).encode() + b"\0" + _HOST_TAG.encode())
    lib_path = BUILD_DIR / f"{stem}_{key.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, *inc, *(str(p) for p in sources), "-o", tmp, *libs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed (rc={r.returncode}, flags "
                               f"{' '.join([*inc, *libs])}):\n{r.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def build() -> Path:
    """Compile the host library unless one for these sources, flags and
    host exists. Raises, with the compiler's stderr, when the build fails."""
    global ZSTD_ROUTE
    ZSTD_ROUTE, inc, libs = _zstd_flags()
    headers = (COMPAT_DIR / "zstd.h",) if ZSTD_ROUTE == "compat" else ()
    return _compile("libflagstats_host", SOURCES, headers, inc, libs)


def build_readers() -> Path:
    """Compile the readers' library (see the module docstring) unless one
    exists; raises like ``build()``."""
    global DEFLATE_ROUTE
    DEFLATE_ROUTE, dflags, dlibs = _deflate_flags()
    return _compile("libflagstats_readers", READER_SOURCES, READER_HEADERS, dflags,
                    ["-lz", *dlibs])


def build_columns() -> Path:
    """Compile the column readers (``flag_columns.cpp``,
    ``cram_columns.cpp``) unless they exist; raises like ``build()``."""
    global DEFLATE_ROUTE
    DEFLATE_ROUTE, dflags, dlibs = _deflate_flags()
    return _compile("libflagstats_columns", COLUMNS_SOURCES, COLUMNS_HEADERS, dflags,
                    ["-lz", *dlibs])


def load():
    """The bound library, built at first use, or None if it cannot be
    built or loaded (``BUILD_ERROR`` says why)."""
    global _lib, BUILD_ERROR
    with _lock:
        if _lib is None and not BUILD_ERROR:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, AttributeError) as e:
                BUILD_ERROR = f"{type(e).__name__}: {e}"
        return _lib


def load_readers():
    """The bound readers' library, built at first use, or None if it
    cannot be built or loaded (``READERS_BUILD_ERROR`` says why)."""
    global _readers, READERS_BUILD_ERROR
    with _readers_lock:
        if _readers is None and not READERS_BUILD_ERROR:
            try:
                _readers = _bind_readers(ctypes.CDLL(str(build_readers())))
            except (OSError, RuntimeError, AttributeError) as e:
                READERS_BUILD_ERROR = f"{type(e).__name__}: {e}"
        return _readers


def load_perf():
    """The bound perf-counter object (``perf_events.cpp``), built at
    first use, or None if it cannot be built or loaded
    (``PERF_BUILD_ERROR`` says why)."""
    global _perf, PERF_BUILD_ERROR
    with _perf_lock:
        if _perf is None and not PERF_BUILD_ERROR:
            try:
                _perf = _bind_perf(ctypes.CDLL(str(_compile("libflagstats_perf", PERF_SOURCES,
                                                             (), [], []))))
            except (OSError, RuntimeError, AttributeError) as e:
                PERF_BUILD_ERROR = f"{type(e).__name__}: {e}"
        return _perf


def load_columns():
    """The bound column readers, built at first use, or None if
    they cannot be built or loaded (``COLUMNS_BUILD_ERROR`` says why)."""
    global _columns, COLUMNS_BUILD_ERROR
    with _columns_lock:
        if _columns is None and not COLUMNS_BUILD_ERROR:
            try:
                _columns = _bind_columns(ctypes.CDLL(str(build_columns())))
            except (OSError, RuntimeError, AttributeError) as e:
                COLUMNS_BUILD_ERROR = f"{type(e).__name__}: {e}"
        return _columns


def columns():
    """The column readers; raises, with ``COLUMNS_BUILD_ERROR``, when
    they did not build (there is no host fallback for a range column)."""
    lib = load_columns()
    if lib is None:
        raise RuntimeError(f"the column readers did not build: {COLUMNS_BUILD_ERROR}")
    return lib


def column_route():
    """The column readers when they and the readers both built, else
    None. The whole-file column reads (``read_bam_flags``,
    ``read_sam_flags``, ``read_cram_flags``) call both objects, so they
    take the native route only with both, and the Python readers
    otherwise, which ``python_route`` states."""
    return load_columns() if load_readers() is not None else None


#: a reader's bound-sized buffer comes back as a view of its column while
#: it is at most this many times the column's length, else as a copy
COLUMN_SLACK = 4


def column(out, got: int):
    """The column ``out[:got]`` that a native reader wrote into the
    bound-sized buffer ``out``: a view, so the column is written once,
    where the buffer is at most ``COLUMN_SLACK`` times the column (the
    pages past it were never touched and cost address space only), else
    a copy, so that a small column keeps no large buffer alive."""
    return out[:got] if out.size <= COLUMN_SLACK * got else out[:got].copy()


def readers():
    """The readers' library; raises, with ``READERS_BUILD_ERROR``, when
    it did not build (for callers that asked for the native walkers)."""
    lib = load_readers()
    if lib is None:
        raise RuntimeError(f"the native readers did not build: {READERS_BUILD_ERROR}")
    return lib


def python_route(what: str) -> None:
    """Say on standard error that ``what`` takes the Python reader
    because the native readers did not build."""
    err = READERS_BUILD_ERROR or COLUMNS_BUILD_ERROR
    first = err.splitlines()[0] if err else ""
    print(f"libflagstats_tpu_torch: {what}: the Python reader (native readers "
          f"unavailable: {first})", file=sys.stderr)


def map_sequential(path, willneed: bool = True):
    """Read-only mapping of a file with MADV_SEQUENTIAL (+ MADV_WILLNEED
    by default): the container walks stream the file front to back, and
    a cold mapping without the prefetch pays one synchronous major fault
    per page. WILLNEED is advisory readahead into the page cache, so
    files larger than RAM degrade gracefully. ``willneed=False`` for
    walks that touch only some of the pages (the columnar CRAM walker
    skips the blocks that carry no FLAG series; prefetching the whole
    file would pay cold IO for bytes the walk never reads). Returns a
    uint8 ndarray view (the mapping stays alive through the array's
    ``.base`` chain)."""
    import mmap as _mmap

    import numpy as np

    with open(path, "rb") as fh:
        mm = _mmap.mmap(fh.fileno(), 0, prot=_mmap.PROT_READ)
    if hasattr(mm, "madvise"):
        mm.madvise(_mmap.MADV_SEQUENTIAL)
        if willneed:
            mm.madvise(_mmap.MADV_WILLNEED)
    return np.frombuffer(mm, dtype=np.uint8)


def fused_flagstat(symbol: str, path, threads: int, fallback_rcs: tuple[int, ...] = ()):
    """Shared driver of the fused container counts (``lfs_bam_flagstat*``,
    ``lfs_sam_flagstat``, ``lfs_bgzf_sam_flagstat``): map the file, call
    the walker with a zeroed uint64[32] counter vector, map its errors.

    Returns the counters, or None when the file is empty or the walker
    returned one of ``fallback_rcs`` (-6: gzip but not BGZF): the caller
    then reads the column and counts it. Other negative rcs raise
    ValueError; a readers' library that did not build raises
    RuntimeError."""
    import numpy as np

    lib = readers()
    size = os.path.getsize(path)
    if size == 0:
        return None
    mm = map_sequential(path)
    counters = np.zeros(32, dtype=np.uint64)
    got = getattr(lib, symbol)(mm.ctypes.data, size,
                               counters.ctypes.data_as(ctypes.c_void_p), threads, 0)
    if got >= 0:
        return counters
    if got in fallback_rcs:
        return None
    raise ValueError(f"{symbol} failed (rc={got}) — file corrupt, "
                     "truncated, or malformed")


def _bind_readers(lib):
    """Declare the readers' symbols (bam_reader.cpp, sam_reader.cpp,
    rans4x8.cpp, cram_reader.cpp). The CRAM walkers take the counter
    vector before the thread count and return the record count through
    a pointer: their order is not that of the BAM and SAM walkers."""
    i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name, res, args in (
        ("lfs_bam_flagstat", i64, [vp, i64, vp, i32, i64]),
        ("lfs_bam_flagstat_parallel", i64, [vp, i64, vp, i32, i64]),
        ("lfs_bam_flagstat_byte_range", i64, [vp, i64, i64, i64, vp, i64p, i64p, i32, i64]),
        ("lfs_sam_bound", i64, [vp, i64]),
        ("lfs_sam_flags", i64, [vp, i64, vp, i64, i32]),
        ("lfs_sam_flagstat", i64, [vp, i64, vp, i32, i64]),
        ("lfs_bgzf_raw_size", i64, [vp, i64]),
        ("lfs_bgzf_sam_flagstat", i64, [vp, i64, vp, i32, i64]),
        ("lfs_bgzf_members", i64, [vp, i64]),
        ("lfs_bgzf_sam_flagstat_range", i64, [vp, i64, i64, i64, vp, i32, i64]),
        ("lfs_rans4x8_bound", i64, [i64]),
        ("lfs_rans4x8_compress", i64, [vp, i64, vp, i64]),
        ("lfs_rans4x8_size", i64, [vp, i64]),
        ("lfs_rans4x8_decompress", i64, [vp, i64, vp, i64]),
        ("lfs_cram_flagstat_range", i64, [vp, i64, i64, i64, vp, i32, i64p]),
        ("lfs_cram_flagstat", i64, [vp, i64, vp, i32, i64p]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _bind_columns(lib):
    """Declare the column readers' symbols (flag_columns.cpp,
    cram_columns.cpp)."""
    i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name, res, args in (
        ("lfs_bam_flags_byte_range", i64, [vp, i64, i64, i64, vp, i64, i64p, i64p, i32]),
        ("lfs_bam_flags_range_bound", i64, [vp, i64, i64, i64]),
        ("lfs_bgzf_sam_flags_range", i64, [vp, i64, i64, i64, vp, i64, i32]),
        ("lfs_bgzf_sam_range_bound", i64, [vp, i64, i64, i64]),
        ("lfs_cram_range_records", i64, [vp, i64, i64, i64, i64p]),
        ("lfs_cram_flags_range", i64, [vp, i64, i64, i64, vp, i64, i32, i64p]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _bind_perf(lib):
    """Declare the perf-counter symbols (perf_events.cpp)."""
    i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    for name, res, args in (
        ("lfs_perf_open", i64, [vp, vp, i32, vp]),
        ("lfs_perf_start", i32, [i64]),
        ("lfs_perf_stop", i32, [i64, vp]),
        ("lfs_perf_close", None, [i64]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _bind(lib):
    """Declare the symbols the port calls (a subset of the library's)."""
    i64, i32, vp, cp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p
    for name, res, args in (
        ("lfs_lz4_compress", i64, [cp, i64, vp, i64, i32]),
        ("lfs_lz4_decompress", i64, [cp, i64, vp, i64]),
        ("lfs_lz4_bound", i64, [i64]),
        ("lfs_zstd_compress", i64, [cp, i64, vp, i64, i32]),
        ("lfs_zstd_decompress", i64, [cp, i64, vp, i64]),
        ("lfs_zstd_bound", i64, [i64]),
        ("lfs_decode_stream", i64, [cp, i64, vp, i64, i32, i32]),
        ("lfs_bit_transpose", i64, [vp, i64, vp, i32]),
        ("lfs_bit_transpose_packed", i64, [vp, i64, vp, vp, i32, i32]),
        ("lfs_flagstat_u16", i64, [vp, i64, vp, i32]),
        ("lfs_flagstat_framed", i64, [vp, i64, i32, i32, vp, vp]),
        ("lfs_pospopcnt_u16", i64, [vp, i64, vp, i32]),
        ("lfs_setop_count", i64, [vp, vp, i64, i32, i32, vp]),
        ("lfs_itf8_decode", i64, [vp, i64, vp, i64]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib

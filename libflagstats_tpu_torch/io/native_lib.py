"""ctypes loader for the native host library (C++, built at first use).

The port builds its own copies of two of the JAX package's C++ host
sources, kept in ``io/csrc/`` byte for byte equal to
``libflagstats_tpu/io/native/`` (tests/test_torch_native_sources.py):
``flagstats_io.cpp`` (the framed LZ4 and Zstd block codecs, the parallel
framed-stream decoder, the fused framed decode+count and the AVX2 host
bit transpose) and ``flagstats_host.cpp`` (the AVX2 host flagstat and
pospopcnt kernels and the POPCNT set-algebra counts). Neither includes a local header, and the port
builds no file of the JAX package.

g++ builds them into ``build/torch_host/``, keyed on a hash of the
sources, the flags and the host tag, through a temp file and a rename,
so a concurrent build never loads a half-written file. ``load()``
returns None when the build fails and keeps the compiler's message in
``BUILD_ERROR``: callers that must not fall back raise with it.

libzstd: where the system ``<zstd.h>`` compiles and ``-lzstd`` links,
the build uses them ("system"); otherwise it takes the declarations in
``io/csrc/compat/zstd.h`` and links the runtime ``libzstd.so.1``
("compat"). ``ZSTD_ROUTE`` says which one the last build probe chose.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
SOURCES = (CSRC / "flagstats_io.cpp", CSRC / "flagstats_host.cpp")
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

#: "system" or "compat": how the last build probe found libzstd
ZSTD_ROUTE: str | None = None
#: why the last ``load()`` returned None ("" until one did)
BUILD_ERROR = ""

_lib = None
_lock = threading.Lock()


def _zstd_flags() -> tuple[str, list[str], list[str]]:
    """The zstd route, its include flags and its link flags: a
    compile+link probe of the system header with the compiler the build
    uses."""
    try:
        r = subprocess.run(["g++", "-x", "c++", "-", "-lzstd", "-o", os.devnull],
                           input=_ZSTD_PROBE, text=True, capture_output=True,
                           timeout=120)
        if r.returncode == 0:
            return "system", [], ["-lzstd"]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "compat", ["-I", str(COMPAT_DIR)], ["-l:libzstd.so.1"]


def build() -> Path:
    """Compile the library unless one for these sources, flags and host
    exists. Raises, with the compiler's stderr, when the build fails."""
    global ZSTD_ROUTE
    ZSTD_ROUTE, inc, libs = _zstd_flags()
    key = hashlib.sha256()
    for p in SOURCES:
        key.update(p.name.encode() + b"\0" + p.read_bytes())
    if ZSTD_ROUTE == "compat":
        key.update((COMPAT_DIR / "zstd.h").read_bytes())
    key.update(" ".join([*CXX_FLAGS, *inc, *libs]).encode() + b"\0" + _HOST_TAG.encode())
    lib_path = BUILD_DIR / f"libflagstats_host_{key.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, *inc, *(str(p) for p in SOURCES),
               "-o", tmp, *libs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed (rc={r.returncode}, zstd route "
                               f"{ZSTD_ROUTE}):\n{r.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


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
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib

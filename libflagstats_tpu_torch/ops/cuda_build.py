"""Build and bind the port's CUDA kernels (ops/csrc/*.cu).

nvcc compiles every source under ops/csrc/ into one shared library with
a plain C interface, bound with ctypes: no PyTorch headers, so a cold
build takes seconds. One nvcc per source runs at once, then one links.
The library is keyed on a hash of the sources (headers included) and
flags, written to a temp file and renamed into build/torch_kernels/, so
concurrent builds never load a half-written file. Nothing is built at
import: ``load()`` builds at first use and raises, with the compiler's
stderr, when nvcc is missing or the build fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ptxas's report (registers, spills) of the last build this process ran
BUILD_LOG = ""

_lib = None


class EpilogueMap(ctypes.Structure):
    """``EpilogueMap`` of csrc/flagstat_epilogue.cuh, passed by value: for
    each FLAG bit k the accumulator's entries of C[k] (``c``, plus ``c2``)
    and of F[k] (``f``), -1 for none; ``qc`` the QC-fail bit."""
    _fields_ = [("c", ctypes.c_int8 * 16), ("c2", ctypes.c_int8 * 16),
                ("f", ctypes.c_int8 * 16), ("qc", ctypes.c_int8)]


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global BUILD_LOG
    srcs = _sources()
    key = hashlib.sha256()
    for p in srcs:
        key.update(p.name.encode() + b"\0" + p.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libflagstats_kernels_{key.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        cus = [p for p in srcs if p.suffix == ".cu"]
        objs = [os.path.join(work, p.stem + ".o") for p in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for p, o in zip(cus, objs)]
        logs = []
        for p, proc in zip(cus, procs):
            _, err = proc.communicate()
            logs.append(f"{p.name}:\n{err}")
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {p.name} "
                                   f"(rc={proc.returncode}):\n{err}")
        tmp = os.path.join(work, lib_path.name)
        r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc={r.returncode}):\n{r.stderr}")
        BUILD_LOG = "\n".join(logs)
        os.replace(tmp, lib_path)
    return lib_path


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: arrays of one entry per card (``lfs_sharded_counts``, ``lfs_sharded_merge``)
_VPS, _I64S, _I32S = (ctypes.POINTER(t) for t in (_VP, _I64, _I32))
#: every entry of the library and its arguments; each returns an int (a
#: cudaError_t, or the constant it names). The launchers take the device
#: ordinal first and the stream last (``kernels.launch``).
ENTRIES = {
    "lfs_stream_sums": [_I32, _I32, _VP, _I64, _VP, _I32, _I32, _VP],
    "lfs_stream_sums_pre": [_I32, _I32, _I32, _VP, _I64, _VP, _I32, _I32, _VP],
    "lfs_stream_sums_words": [_I32, _VP, _I64, _VP, _I32, _I32, _VP],
    "lfs_epilogue": [_I32, _VP, _VP, EpilogueMap, _I64, _I32, _VP, _VP, _VP],
    "lfs_flagstat_count": [_I32, _I32, _VP, _I64, _VP, _VP, _VP, EpilogueMap, _VP, _VP, _VP,
                           _VP],
    "lfs_sharded_counts": [_I32, _I32, _I32S, _VPS, _I64S, _VPS, _VP, _VPS, _VPS],
    "lfs_sharded_merge": [_I32, _VP, _VP, _I32, _I32, EpilogueMap, _I64, _VP, _VP, _VPS, _VP, _VP],
    "lfs_setop_count_cuda": [_I32, _I32, _VP, _VP, _I64, _VP, _VP],
    "lfs_read_xor": [_I32, _VP, _I64, _VP, _VP],
    "lfs_transpose_xor": [_I32, _VP, _I64, _I32, _VP, _VP],
    "lfs_transform_xor": [_I32, _VP, _I64, _I32, _VP, _VP],
    "lfs_stream_sums_raw": [_I32, _VP, _I64, _I32, _VP, _VP],
    "lfs_fold_xor": [_I32, _VP, _I64, _I32, ctypes.c_uint32, _VP, _VP],
    "lfs_lz4_decode": [_I32, _VP, _I64, _VP, _I32, _I32, _VP, _I64, _VP, _VP],
    "lfs_wave_blocks": [_I32, ctypes.c_char_p, _I32, ctypes.POINTER(ctypes.c_int)],
    "lfs_words_per_block": [],
    "lfs_words_block_words": [],
    "lfs_words_flush_bodies": [],
}


def load() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in ENTRIES.items():
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib

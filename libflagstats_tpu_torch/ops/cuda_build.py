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
    """``EpilogueMap`` of csrc/flagstat_epilogue.cu, passed by value: for
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


def load() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.lfs_stream_sums.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.lfs_stream_sums.restype = ctypes.c_int
        lib.lfs_wave_blocks.argtypes = [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.lfs_wave_blocks.restype = ctypes.c_int
        lib.lfs_words_per_block.argtypes = []
        lib.lfs_words_per_block.restype = ctypes.c_int
        lib.lfs_stream_sums_pre.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
        lib.lfs_stream_sums_pre.restype = ctypes.c_int
        lib.lfs_pre_wave_blocks.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
        lib.lfs_pre_wave_blocks.restype = ctypes.c_int
        lib.lfs_stream_sums_words.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                              ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p]
        lib.lfs_stream_sums_words.restype = ctypes.c_int
        lib.lfs_words_wave_blocks.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.lfs_words_wave_blocks.restype = ctypes.c_int
        for name in ("lfs_words_block_words", "lfs_words_flush_bodies"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        vp, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
        for name, args in (("lfs_read_xor", [vp, i64, vp, vp]),
                           ("lfs_transpose_xor", [vp, i64, i32, vp, vp]),
                           ("lfs_transform_xor", [vp, i64, i32, vp, vp]),
                           ("lfs_stream_sums_raw", [vp, i64, i32, vp, vp]),
                           ("lfs_fold_xor", [vp, i64, i32, u32, vp, vp]),
                           ("lfs_setop_count_cuda", [i32, vp, vp, i64, vp, vp]),
                           ("lfs_epilogue", [vp, vp, EpilogueMap, i64, i32, vp, vp, vp])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib

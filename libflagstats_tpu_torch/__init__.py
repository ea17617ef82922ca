"""libflagstats_tpu_torch — the flagstat engine on PyTorch and CUDA.

The port of ``libflagstats_tpu`` (JAX/Pallas on a TPU) to PyTorch with a
hand-written CUDA kernel for NVIDIA Hopper. It imports torch and numpy
and never jax, not even through ``libflagstats_tpu``.

Public API:
  flagstats(values)        pyflagstats-compatible dict (python/libflagstats.pyx:8-37)
  flagstats_u16(arr, out)  32-counter vector, streaming-accumulative
                           (libflagstats.h:3025)
  pospopcnt_u16(arr)       16-bin positional popcount (libalgebra.h:3497)
  get_function(n, impl)    the counting callable of one tier
  counters_to_report(c)    samtools flagstat report object
  flagstat_stream(path)    streaming flagstat of a framed LZ4/Zstd file
                           (io/stream.py)
  flagstat_sharded(values) data-parallel flagstat over devices
                           (parallel/sharded.py, imported at first call)
  popcnt / intersect_count / union_count / diff_count
                           set-algebra popcounts over bitmaps (libalgebra.h)
"""
from __future__ import annotations

import numpy as np

from . import flags
from .flags import (  # noqa: F401
    FPAIRED, FPROPER_PAIR, FUNMAP, FMUNMAP, FREVERSE, FMREVERSE,
    FREAD1, FREAD2, FSECONDARY, FQCFAIL, FDUP, FSUPPLEMENTARY,
    BIT12, BIT13, BIT14,
)
from .io.stream import flagstat_stream  # noqa: F401
from .ops.dispatch import flagstats_u16, get_function, pospopcnt_u16  # noqa: F401
from .ops.setalgebra import diff_count, intersect_count, popcnt, union_count  # noqa: F401
from .report import FlagstatReport, counters_to_dict, counters_to_report  # noqa: F401

__version__ = "0.1.0"


def flagstats(values, impl: str | None = None, device=None) -> dict:
    """pyflagstats-compatible entry point (reference: python/libflagstats.pyx:8-37)."""
    if not isinstance(values, np.ndarray):
        raise ValueError("Values must be an numpy.ndarray")
    if values.dtype != np.uint16:
        raise ValueError('Values must have the dtype "uint16"')
    if values.ndim != 1:
        raise ValueError(f"Values must be 1-D, got shape {values.shape}")
    counters = flagstats_u16(np.ascontiguousarray(values), impl=impl, device=device)
    return counters_to_dict(counters, len(values))


def flagstat_sharded(values, **kwargs):
    """Data-parallel flagstat over devices (see parallel.sharded); the
    module loads at the first call, not with the package."""
    from .parallel.sharded import flagstat_sharded as _fs

    return _fs(values, **kwargs)

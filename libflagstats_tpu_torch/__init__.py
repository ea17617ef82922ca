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
  flagstat_file(path)      flagstat of any container: .bam, .sam[.gz],
                           .cram, framed .lz4/.zst, raw binary column
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


def flagstat_file(path, threads: int = 0, impl: str | None = None, device=None):
    """32-counter vector straight from any supported container — the
    `samtools flagstat <file>` workload with no samtools in the loop
    (format sniffed by io.sniff_format: .bam, .sam[.gz], .cram, framed
    .lz4/.zst, raw binary column).

    It counts on the card unless asked otherwise, like every entry point
    of the port (the JAX package's default for BAM, BGZF-SAM and CRAM is
    the fused host walk+count): BAM, SAM and CRAM read the column with
    the native readers and count it with ``impl`` on ``device``
    (io/bamio.py, io/samio.py, io/cramio.py; ``impl="native"`` names the
    fused host walk+count);
    framed files stream through ``flagstat_stream``, or, for an impl
    the stream has not (``"numpy"``, ``"cuda_report"``,
    ``"cuda_words"``), decode the column and count it; a raw column
    counts through ``flagstats_u16``. With no card and neither
    ``device`` nor a host ``impl``, it raises."""
    from .io import read_flags_auto, sniff_format
    from .io.stream import DEVICE_IMPLS

    kind = sniff_format(path)
    if kind == "bam":
        from .io.bamio import flagstat_bam

        return flagstat_bam(path, threads=threads, impl=impl, device=device)
    if kind == "sam":
        from .io.samio import flagstat_sam

        return flagstat_sam(path, threads=threads, impl=impl, device=device)
    if kind == "cram":
        from .io.cramio import flagstat_cram

        return flagstat_cram(path, threads=threads, impl=impl, device=device)
    if kind.startswith("framed-") and impl in (None, "native", *DEVICE_IMPLS):
        return flagstat_stream(path, codec=kind.removeprefix("framed-"), impl=impl,
                               threads=threads, device=device)
    return flagstats_u16(read_flags_auto(path, threads=threads, kind=kind),
                         impl=impl, device=device)

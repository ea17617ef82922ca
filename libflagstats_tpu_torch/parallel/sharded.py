"""Data-parallel flagstat over several devices of one process.

The counterpart of ``libflagstats_tpu.parallel.sharded`` (a 1-D JAX
mesh, ``shard_map`` and ``psum``). The reference's natural shard unit is
the sequential stream of independent blocks whose partial counters
accumulate into one array (reference: benchmark/flagstats.cpp:311-332).
Here the FLAG column is split into one contiguous shard per device
entry, each device runs the local kernel, and the per-device (C[k],
F[k]) stream sums, an int64[2, 16] payload, are moved to the first
device and added: that add is the psum. The derived pass total (counter
9) is applied once, after the merge, with the true word count.

No shard is padded: the kernels mask their own ragged edges, so
``shard_bounds`` takes the place of the JAX package's ``pad_for_mesh`` /
``shard_granule``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import dispatch as D
from ..ops import kernels as K
from ..ops.bitslice import pretranspose_host_packed
from ..ops.torch_ops import as_words, assemble_counters, stream_sums_torch
from ..ops.words_kernels import stream_sums_words_cuda

#: the local impls, counterparts of the JAX package's pallas, pallas_pre,
#: pallas_words and xla
SHARDED_IMPLS = ("cuda", "cuda_pre", "cuda_words", "torch")


def data_devices(devices=None) -> list[torch.device]:
    """The devices to shard over (the counterpart of ``data_mesh``): the
    given entries, which may repeat, or by default every CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices "
                               "(e.g. devices=['cpu']) to shard on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices is empty")
    if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
        raise RuntimeError(f"devices {list(devices)} include a CUDA device, and "
                           "no CUDA device is available")
    return devs


def _granule(impl: str) -> int:
    """Words a shard or round bound falls on a multiple of: 8 (16 bytes),
    or whole 65,536-word transpose groups for ``"cuda_pre"``."""
    return K.GROUP_WORDS if impl == "cuda_pre" else 8


def shard_bounds(n: int, parts: int, impl: str = "cuda") -> list[tuple[int, int]]:
    """``parts`` contiguous near-equal [start, stop) ranges covering n
    words. Every bound but n falls on a multiple of ``_granule(impl)``
    words, so a 16-byte aligned column stays 16-byte aligned in every
    shard."""
    granule = _granule(impl)
    units = -(-n // granule)
    cuts = [min(n, units * i // parts * granule) for i in range(parts)] + [n]
    return list(zip(cuts[:-1], cuts[1:]))


def _check_impl(impl: str) -> None:
    if impl not in SHARDED_IMPLS:
        # counters would come back right through another tier, so a
        # mistyped impl would silently check or time the wrong kernel
        raise ValueError(f"unknown sharded impl {impl!r} (choose one of "
                         f"{SHARDED_IMPLS}; report mode is the report= flag, "
                         "not an impl name)")


def _local_sums(words: torch.Tensor, dev: torch.device, impl: str,
                report: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(C[k], F[k]) of one shard counted on ``dev``, each (16,) int64."""
    if impl == "cuda_pre":
        host = words.cpu().numpy().view(np.uint16)
        planes = pretranspose_host_packed(host, K.packed_rows_for(report))
        sums = K.stream_sums_pre_cuda(torch.from_numpy(planes).to(dev), report, packed=True)
        return K._sums_to_streams(sums, report)
    words = words.to(dev)
    if impl == "cuda":
        sums = K.stream_sums_cuda(words, "flagstat_report" if report else "flagstat")
        return K._sums_to_streams(sums, report)
    if impl == "cuda_words":
        return stream_sums_words_cuda(words)
    return stream_sums_torch(words)


def sharded_sums(words: torch.Tensor, devices: list[torch.device], impl: str,
                 report: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(C[k], F[k]) of a word stream split over ``devices``, merged on
    the first one. Streams past DEVICE_WORD_CAP go in accumulating
    rounds, each split over every device."""
    _check_impl(impl)
    total = torch.zeros(16, dtype=torch.int64, device=devices[0])
    fail = torch.zeros_like(total)
    for part in D._device_chunks(words, _granule(impl)):
        for dev, (a, b) in zip(devices, shard_bounds(len(part), len(devices), impl)):
            t, f = _local_sums(part[a:b], dev, impl, report)
            total += t.to(devices[0])
            fail += f.to(devices[0])
    return total, fail


def flagstat_sharded(x, devices=None, impl: str | None = None,
                     report: bool = False) -> np.ndarray:
    """One-call data-parallel flagstat of a uint16 column (numpy array
    or tensor) -> (32,) uint64.

    ``devices``: the devices to shard over, one shard per entry (entries
    may repeat; default every CUDA device). ``impl``: one of
    SHARDED_IMPLS; None follows ``ops.dispatch.device_impl`` of the first
    device. ``report=True`` counts the 21 report streams on ``"cuda"``
    and ``"cuda_pre"`` (only flags.REPORT_COUNTERS are kept); the other
    impls count all 32 counters either way."""
    arr = D._validate_u16(x)   # the lossless-cast rules of flagstats_u16
    devs = data_devices(devices)
    if impl is None:
        impl = D.device_impl(devs[0])
    _check_impl(impl)
    total, fail = sharded_sums(as_words(arr), devs, impl, report)
    return assemble_counters(total, fail, len(arr)).cpu().numpy().astype(np.uint64)

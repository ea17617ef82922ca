"""Data-parallel flagstat over several devices of one process.

The counterpart of ``libflagstats_tpu.parallel.sharded`` (a 1-D JAX
mesh, ``shard_map`` and ``psum``). The reference's natural shard unit is
the sequential stream of independent blocks whose partial counters
accumulate into one array (reference: benchmark/flagstats.cpp:311-332).
Each shard is counted into a ``staging.Tally`` on its device, and the
tallies' raw int64 sums, which add, are copied onto the first device and
added there (``Tally.take``): that add is the psum. The merged tally then
ends as any single count does: on a card one epilogue launch, the copy
of the 32 counters into a pinned buffer and one wait; on the CPU the
plain ``assemble_counters``. The derived pass total (counter 9) is
applied once, at that end, with the true word count.

Two forms. ``flagstat_sharded(column, devices)`` splits one column into
one contiguous shard per device entry (``shard_bounds``; no shard is
padded, the kernels mask their own ragged edges) and sends each shard
to its device. ``flagstat_sharded([shard, ...])`` counts shards that
already lie on their devices where they lie, with no split and no copy:
the deployment that keeps a column sharded across the cards. Either way
every device's count is enqueued before anything waits, so the cards
count at once.

A host column's shards are counted through the staging rings
(``ops/staging.py``), one ring per device: the shards' pieces are
taken in turn across the devices, so copies to different cards
overlap, and on repeated entries of one card the copy of one piece
overlaps the count of the one before. ``cuda_pre`` transposes on the
host, so its shards always go through the rings.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..bench import profiling
from ..ops import dispatch as D
from ..ops import kernels as K
from ..ops.staging import Tally, stage
from ..ops.torch_ops import as_words

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


#: flagstat_sharded calls, the shards they counted, and the accumulators
#: copied onto the first shard's device to merge (counted where each
#: happens and nowhere else)
SHARDED = {"calls": 0, "shards": 0, "peer_copies": 0}


def _device(d) -> torch.device:
    """``d`` as a torch.device, a CUDA device with its index."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _new_tallies(devices, impl: str, report: bool) -> list[Tally]:
    """One tally a device entry; the first entry of each card counts into
    this thread's accumulator there (``Tally(scratch=True)``)."""
    seen, out = set(), []
    for dev in devices:
        dev = _device(dev)
        out.append(Tally(impl, dev, report, scratch=dev not in seen))
        seen.add(dev)
    return out


#: each thread's tallies of its last ``flagstat_sharded`` count:
#: ((devices, impl, report), tallies)
_KEPT = threading.local()


def _tallies(devices, impl: str, report: bool) -> list[Tally]:
    """``_new_tallies`` of a count read back to the host before it
    returns, cleared. A thread keeps them for its next such count over
    the same devices, impl and mode: each device's stream orders one
    count's uses of an accumulator before the next count's, and on the
    CPU every use is over when the call returns."""
    key = (tuple(_device(d) for d in devices), impl, report)
    kept = getattr(_KEPT, "last", None)
    if kept is not None and kept[0] == key:
        for t in kept[1]:
            t.clear()
        return kept[1]
    _KEPT.last = (key, _new_tallies(key[0], impl, report))
    return _KEPT.last[1]


def _local_sums(shards, impl: str) -> None:
    """Count each (words, tally) shard into its tally, enqueued. Words
    already on a card, and ``"torch"``'s, are counted where they are
    sent, first: on a card one launch a shard. Host shards of the kernel
    impls then go through the staging rings together, their pieces in
    turn (``cuda_pre``'s always: it transposes on the host)."""
    staged = []
    for w, t in shards:
        if impl == "cuda_pre" or (impl != "torch" and w.device.type == "cpu"):
            staged.append((w.cpu(), t))
        else:
            t.add(w.to(t.device))
    stage(staged)


def _merge(tallies: list[Tally]) -> Tally:
    """The first tally, with the raw sums of the others added into it on
    its device (span ``lfs.shard.merge``): a peer copy each, all at once,
    then one reduction and one add, enqueued."""
    first = tallies[0]
    with profiling.span("lfs.shard.merge", peers=len(tallies) - 1):
        first.take(tallies[1:])
        SHARDED["peer_copies"] += len(tallies) - 1
    return first


def _count_column(words: torch.Tensor, tallies: list[Tally], impl: str) -> None:
    """Split a word stream over the tallies' devices and count it into
    them. Streams past DEVICE_WORD_CAP go in accumulating rounds, each
    split over every device."""
    for part in D._device_chunks(words, _granule(impl)):
        bounds = shard_bounds(len(part), len(tallies), impl)
        _local_sums([(part[a:b], t) for t, (a, b) in zip(tallies, bounds)], impl)


def sharded_sums(words: torch.Tensor, devices: list[torch.device], impl: str,
                 report: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(C[k], F[k]) of a word stream split over ``devices``, merged on
    the first one, each (16,) int64 there (see ``_count_column``)."""
    _check_impl(impl)
    tallies = _new_tallies(devices, impl, report)   # the sums stay on the devices
    _count_column(words, tallies, impl)
    return _merge(tallies).streams()


def _shard_words(shards) -> list[torch.Tensor]:
    """The shards as flat int16 word views, each on its own device, or
    raise: every entry a 1-D uint16 (or int16 view) tensor."""
    out = []
    for i, s in enumerate(shards):
        if not isinstance(s, torch.Tensor) or s.dtype not in (torch.uint16, torch.int16) \
                or s.ndim != 1:
            what = (f"a {s.ndim}-D {s.dtype} tensor" if isinstance(s, torch.Tensor)
                    else type(s).__name__)
            raise ValueError(f"shard {i} is {what}; each shard is a 1-D uint16 "
                             "(or int16) tensor")
        out.append(as_words(s.contiguous()))
    return out


def _is_shards(x) -> bool:
    """Whether ``x`` is the list form: a list or tuple holding tensors."""
    return isinstance(x, (list, tuple)) and any(isinstance(s, torch.Tensor) for s in x)


def flagstat_sharded(x, devices=None, impl: str | None = None,
                     report: bool = False) -> np.ndarray:
    """One-call data-parallel flagstat -> (32,) uint64.

    ``x``: a uint16 column (numpy array or tensor), split into one shard
    per entry of ``devices`` (entries may repeat; default every CUDA
    device); or a list or tuple of shards, 1-D uint16 (or int16)
    tensors, each counted on the device it lies on, with no split and no
    copy (``cuda_pre``, which transposes on the host, copies each shard
    there). Shards may be uneven or empty; their lengths add up to the
    word count; a shard past DEVICE_WORD_CAP goes in rounds. ``devices``
    is then None or the shards' devices, in order. ``impl``: one of
    SHARDED_IMPLS; None follows ``ops.dispatch.device_impl`` of the first
    device. ``report=True`` counts the 21 report streams on ``"cuda"``
    and ``"cuda_pre"`` (only flags.REPORT_COUNTERS are kept); the other
    impls count all 32 counters either way. Span
    ``lfs.flagstat_sharded``, args shards, words and impl."""
    with profiling.span("lfs.flagstat_sharded") as call:
        if _is_shards(x):
            column, shards = None, _shard_words(x)
            devs = [_device(s.device) for s in shards]
            if devices is not None and [_device(d) for d in data_devices(devices)] != devs:
                raise ValueError(f"devices {list(devices)} are not the shards' devices "
                                 f"{[str(d) for d in devs]}")
            n = sum(s.numel() for s in shards)
        else:
            column = as_words(D._validate_u16(x))   # flagstats_u16's lossless-cast rules
            devs = data_devices(devices)
            n = column.numel()
        if impl is None:
            impl = D.device_impl(devs[0])
        _check_impl(impl)
        call.note(shards=len(devs), words=n, impl=impl)
        tallies = _tallies(devs, impl, report)
        if column is not None:
            _count_column(column, tallies, impl)
        else:
            rounds = [list(D._device_chunks(s, _granule(impl))) for s in shards]
            for r in range(max(len(c) for c in rounds)):
                _local_sums([(c[r], t) for c, t in zip(rounds, tallies) if r < len(c)],
                            impl)
        SHARDED["calls"] += 1
        SHARDED["shards"] += len(devs)
        return _merge(tallies).counters(n)

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

A list-form count with impl ``"cuda"`` (either mode) over two or more
shards, each on a different card and within DEVICE_WORD_CAP (one round),
is two native calls and one wait (``_native_cards``, ``_Native``):
``lfs_sharded_counts`` enqueues, card by card, the accumulator's memset
and K1 (K3), then each other card's peer copy of its sums into a row of
one buffer on the first card and an event; ``lfs_sharded_merge`` makes
the first card's stream wait on those events and launches one
merge-epilogue kernel, which adds the rows into the first card's sums
and writes the 32 counters, then copies them into a pinned buffer.
Every other count keeps the path above.

A host column's shards are counted through the staging rings
(``ops/staging.py``), one ring per device: the shards' pieces are
taken in turn across the devices, so copies to different cards
overlap, and on repeated entries of one card the copy of one piece
overlaps the count of the one before. ``cuda_pre`` transposes on the
host, so its shards always go through the rings.
"""
from __future__ import annotations

import ctypes
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
#: flagstat_sharded calls counted in two native calls (``_Native``)
ONE_CALL = {"calls": 0}


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


def _card(shard: torch.Tensor) -> torch.device | None:
    """The CUDA device ``shard`` lies on, or None."""
    return shard.device if shard.device.type == "cuda" else None


def _native_cards(shards, impl: str) -> list[torch.device] | None:
    """The cards of a list-form count that is two native calls, or None
    for the general path: impl ``"cuda"``, two or more shards, each on a
    different CUDA device and within DEVICE_WORD_CAP (one round)."""
    if impl != "cuda" or len(shards) < 2:
        return None
    cards = [_card(s) for s in shards]
    if None in cards or len(set(cards)) < len(cards):
        return None
    if any(s.numel() > D.DEVICE_WORD_CAP for s in shards):
        return None
    return cards


def _card_buffers(cards, sums: int) -> tuple[torch.Tensor, list]:
    """(rows, events) of a native count over ``cards``: an int64 buffer of
    the other cards' ``sums`` sums, a row each, on the first card, and a
    timing-free event made on each other card. Peer access is torch's, as
    on the general path: it enables it at its first cross-card copy, here
    of each other card's accumulator into its row."""
    rows = torch.empty((len(cards) - 1, sums), dtype=torch.int64, device=cards[0])
    events = []
    for row, dev in zip(rows, cards[1:]):
        row.copy_(K.scratch(dev).acc[:sums])
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))   # made on dev
        events.append(event)
    for dev in cards:
        torch.cuda.synchronize(dev)
    return rows, events


class _Native:
    """One thread's native count over one tuple of cards in one mode
    (``"flagstat"``; ``"flagstat_report"``: K3): each card's accumulator
    is its ``kernels.scratch``'s, the first card's scratch takes the
    counters (its out, pinned buffer and event ``done``), and
    ``_card_buffers`` gives the rows and the other cards' events. The
    ctypes arrays the entries take are built once; a call fills only the
    shards' addresses, lengths and streams.

    The hazards are the general path's: a card's next memset is enqueued
    behind its own peer copy on its stream, and the rows are rewritten
    only after this call's wait, which follows the merge's read of them."""

    def __init__(self, cards, mode: str):
        k, sums = len(cards), K.RAW_STREAMS[mode]
        self.cards, self.mode = cards, mode
        self.first = K.scratch(cards[0])
        self.rows, self.events = _card_buffers(cards, sums)
        self.ordinals = (ctypes.c_int * k)(*(d.index for d in cards))
        self.accs = (ctypes.c_void_p * k)(*(K.scratch(d).acc.data_ptr() for d in cards))
        self.peer_events = (ctypes.c_void_p * (k - 1))(*(e.cuda_event for e in self.events))
        self.words = (ctypes.c_void_p * k)()
        self.n = (ctypes.c_int64 * k)()
        self.streams = (ctypes.c_void_p * k)()
        self.counts = (k, K._MODE_ID[mode], self.ordinals, self.words, self.n, self.accs,
                       self.rows.data_ptr(), self.peer_events, self.streams)
        self.merge = (self.first.acc.data_ptr(), self.rows.data_ptr(), k - 1, sums,
                      K._map_arg(mode))
        self.readback = (self.first.out.data_ptr(), self.first.host.data_ptr(),
                         self.peer_events, self.first.done.cuda_event)

    def count(self, shards, n: int) -> np.ndarray:
        """The 32 counters of the shards' ``n`` words (uint64): the
        counts (span ``lfs.launch``, none for 0 words), the merge (span
        ``lfs.shard.merge``) and one wait (span ``lfs.readback``). Counts
        a K1 (K3) launch a shard that is not empty and one epilogue in
        ``LAUNCHES``."""
        ran = 0
        for i, (s, dev) in enumerate(zip(shards, self.cards)):
            self.words[i] = s.data_ptr()
            self.n[i] = m = s.numel()
            self.streams[i] = K.raw_stream(dev)
            ran += m > 0
        with profiling.span("lfs.launch", mode=self.mode, words=n) if n else profiling.NOOP:
            K.native("lfs_sharded_counts", self.mode, *self.counts)
        K.LAUNCHES[self.mode] += ran
        with profiling.span("lfs.shard.merge", peers=len(self.cards) - 1):
            K.launch("lfs_sharded_merge", "epilogue", self.cards[0], *self.merge, n,
                     *self.readback)
        with profiling.span("lfs.readback"):
            self.first.done.synchronize()
            return self.first.host_np.astype(np.uint64)


def _native(cards, report: bool) -> _Native:
    """This thread's ``_Native`` over ``cards`` in the mode ``report``
    asks for, kept beside its tallies for its next such count."""
    key = (tuple(cards), report)
    kept = getattr(_KEPT, "native", None)
    if kept is None or kept[0] != key:
        kept = _KEPT.native = (key, _Native(cards, "flagstat_report" if report
                                            else "flagstat"))
    return kept[1]


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
    impls count all 32 counters either way. Shards with impl ``"cuda"``,
    two or more, each on a different card and within DEVICE_WORD_CAP,
    are counted in two native calls and one wait (``_native_cards``;
    ``ONE_CALL``); any other count takes the general path. Span
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
        cards = None if column is not None else _native_cards(shards, impl)
        if cards is not None:
            counts = _native(cards, report).count(shards, n)
            ONE_CALL["calls"] += 1
            SHARDED["calls"] += 1
            SHARDED["shards"] += len(cards)
            SHARDED["peer_copies"] += len(cards) - 1
            return counts
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

"""Multi-process flagstat over ``torch.distributed``.

The counterpart of ``libflagstats_tpu.parallel.multihost``. BASELINE's
north star: shard the FLAG stream across processes, each counting its
own shard on its own device, and merge the counters with one all-reduce
at the end. The payload is one int64[2, 16] tensor of (C[k], F[k])
stream sums per merge, 256 bytes whatever the stream's length; the
derived pass total (counter 9) is applied once, after the merge.

One process runs per rank. ``initialize`` wraps ``init_process_group``;
the caller names the backend: NCCL for one GPU per rank, gloo where
ranks share a GPU (NCCL refuses two ranks on one device) or run on the
CPU. Collectives run on the current CUDA device under NCCL and on the
CPU otherwise.

The collectives are int64. torch has no uint64 all-reduce, and every
counter and word count stays below 2^63, so int64 is exact: the JAX
package's (lo, hi) uint32 pairs, which guarded against JAX's silent
int64 -> int32 downcast, are not needed here.

The framed-file leg counts each rank's block range through the device
stream's loop (io/stream.framed_range_sums: runs of whole frames
decoded straight into pinned slots, then K1, K2 or the torch tier), and
only the int64 (C[k], F[k]) sums cross ranks. The three container
legs count on the card as the single-file path does: each rank reads
the FLAG column of its range of the file (a BGZF SAM member range, a
BAM inflated-byte range, a CRAM container range) and counts it on its
device; the BGZF SAM and BAM legs read with the range column readers
(io/csrc/flag_columns.cpp) and count through ``flagstat_multihost``,
so the derived pass total is applied once, after the merge. With no
card and no ``device`` every rank raises before it reads.
``impl="native"`` names the fused host range walkers of the JAX
package's legs, and only the 32 counters cross ranks. A local
``ValueError`` (or, on the framed-file leg, a failed decode) reaches
the ranks' exchange as ok=0 before anything is raised or merged: the
BAM leg then falls back to rank 0 counting the whole file, the other
legs raise on every rank together, so no rank is left waiting.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import flags as F
from ..io import codec as C
from ..io import stream as S
from ..ops import dispatch as D
from ..ops import native_host
from ..ops.torch_ops import as_words, assemble_counters
from .sharded import data_devices, sharded_sums


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               timeout: datetime.timedelta = datetime.timedelta(minutes=10)) -> bool:
    """Join the process group; True when this call initialized it.

    With no ``world_size`` and no ``WORLD_SIZE`` in the environment this
    is a no-op (a single-process run). Otherwise ``backend`` must be
    given ("nccl" or "gloo"); ``init_method`` defaults to ``"env://"``
    and ``rank`` to ``RANK`` from the environment."""
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if backend is None:
        raise ValueError("name the backend: 'nccl' (one GPU per rank) or "
                         "'gloo' (ranks sharing a GPU, or the CPU)")
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout)
    return True


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> tuple[int, int]:
    """(world size, rank); (1, 0) outside a process group."""
    if _in_group():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce_i64(values) -> torch.Tensor:
    """Sum an int64 tensor (or array) over ranks -> int64 on the CPU
    (identity outside a process group; a group of one still runs the
    collective)."""
    t = torch.as_tensor(values, dtype=torch.int64)
    if not _in_group():
        return t.cpu()
    t = t.to(_comm_device())
    dist.all_reduce(t)
    return t.cpu()


def _allgather_i64(values: np.ndarray) -> np.ndarray:
    """Gather a small int64 vector from every rank -> (P, len) int64
    (a (1, len) reshape outside a process group)."""
    v = torch.as_tensor(np.asarray(values, dtype=np.int64).ravel())
    if not _in_group():
        return v.numpy().reshape(1, -1)
    v = v.to(_comm_device())
    out = [torch.empty_like(v) for _ in range(dist.get_world_size())]
    dist.all_gather(out, v)
    return torch.stack(out).cpu().numpy()


def _global_counter_sum(counters: np.ndarray) -> np.ndarray:
    """Sum a uint64[32] counter vector over ranks."""
    summed = _all_reduce_i64(np.asarray(counters, dtype=np.uint64).view(np.int64))
    return summed.numpy().view(np.uint64)


def _global_sum(value: int) -> int:
    """All-reduce a host integer over ranks."""
    return int(_all_reduce_i64([value])[0])


def _global_max(value: int) -> int:
    """The largest of a host integer over ranks."""
    return int(_allgather_i64(np.array([value])).max())


def _local_device(device) -> torch.device:
    """Where this rank counts: ``device``, else its current CUDA device
    (set it per rank with ``torch.cuda.set_device``)."""
    if device is not None:
        return data_devices([device])[0]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to count this rank's shard on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def flagstat_multihost(local_flags, total_words: int | None = None,
                       impl: str | None = None, pad_to_words: int | None = None,
                       device=None) -> np.ndarray:
    """Count a FLAG stream sharded over ranks: every rank passes its own
    shard (a uint16 numpy array or tensor) and gets the global (32,)
    uint64 counters.

    ``total_words``: the global true word count (default: the sum of the
    local sizes, before any padding). ``pad_to_words``: accepted as in
    the JAX package, where it made the global array's shards equal; it
    must be >= this rank's shard. No word is padded here (the kernels
    mask their edges), so it changes no count. ``device``: where this
    rank counts (default: its current CUDA device); ``impl``: a sharded
    impl, or None for ``ops.dispatch.device_impl`` of that device."""
    local = D._validate_u16(local_flags)
    dev = _local_device(device)
    if impl is None:
        impl = D.device_impl(dev)
    if total_words is None:
        # the true local sizes: counter 9 is derived as total_words -
        # n_fail, so pad words in the sum would inflate the pass total
        total_words = _global_sum(len(local))
    if total_words > D.DEVICE_WORD_CAP:
        # every rank derives the same round count from the agreed total,
        # so all take part in the same collectives; each round re-agrees
        # its true total (shards may be uneven)
        rounds = -(-total_words // D.DEVICE_WORD_CAP)
        cuts = [len(local) * i // rounds for i in range(rounds + 1)]
        acc = np.zeros(F.N_COUNTERS, dtype=np.uint64)
        for a, b in zip(cuts[:-1], cuts[1:]):
            acc += flagstat_multihost(local[a:b], total_words=_global_sum(b - a), impl=impl,
                                      pad_to_words=_global_max(b - a), device=dev)
        return acc
    if pad_to_words is not None and pad_to_words < len(local):
        raise ValueError(
            f"pad_to_words={pad_to_words} < local shard size {len(local)}; "
            "every rank must pass a value >= the largest shard")
    total, fail = sharded_sums(as_words(local), [dev], impl)
    sums = _all_reduce_i64(torch.stack([total, fail]))
    return assemble_counters(sums[0], sums[1], total_words).numpy().astype(np.uint64)


def flagstat_multihost_file(path, codec: str | int = "lz4", impl: str | None = None,
                            n_threads: int = 0, device=None) -> np.ndarray:
    """Multi-process flagstat of one framed compressed stream.

    Each rank scans the frame index (headers only) and takes its
    contiguous block range (the reference's sequential block loop,
    flagstats.cpp:311-332, spread across processes). The stream's impls
    (``"cuda"``, ``"cuda_pre"``, ``"torch"``; ``impl=None`` is
    ops.dispatch.device_impl of ``device``) count the range through the
    device stream's loop (io/stream.framed_range_sums: runs of whole
    frames decoded straight into its pinned slots), and the int64
    (C[k], F[k]) sums merge in one all-reduce; counter 9 is derived once,
    after it, from the global word count. Other sharded impls
    (``"cuda_words"``) decode the range into a column and count it with
    ``flagstat_multihost``. ``impl="native"``, asked for by name: each
    rank runs the fused C++ decode+count over its byte range, and only
    the 32 counters cross processes. Whatever the impl, a local
    ``ValueError`` or failed decode reaches the ranks' exchange as ok=0
    before any collective that counts, and every rank raises: the failed
    one its own error, the others one that names it."""
    if impl is None:
        impl = D.device_impl(device)
    frames = C.scan_frames(path)
    size, rank = _world()
    ranges = C.shard_block_ranges(len(frames), size)
    start, stop = ranges[rank]

    def agreed(step, *args, **kwargs):
        """``step(*args, **kwargs)``, returned once every rank's step is
        known to have succeeded. A bad range or a failed decode (the
        decoders raise RuntimeError for LZ4 and Zstd) must reach the
        exchange as ok=0: raising here would leave the other ranks
        waiting in a collective."""
        out, err = None, None
        try:
            out = step(*args, **kwargs)
        except (ValueError, RuntimeError) as e:
            err = e
        _agree(err, "flagstat_multihost_file")
        return out

    if impl == "native":
        local, _ = agreed(native_host.flagstat_framed_range_native, path,
                          C._codec_id(codec), start, stop, threads=n_threads, frames=frames)
        return _global_counter_sum(local)
    words = [sum(r for _, r, _ in frames[a:b]) // 2 for a, b in ranges]
    if impl in S.DEVICE_IMPLS:
        sums = agreed(S.framed_range_sums, path, codec, start, stop, impl, threads=n_threads,
                      device=_local_device(device))
        merged = _all_reduce_i64(torch.stack(sums))
        return assemble_counters(merged[0], merged[1], sum(words)).numpy().astype(np.uint64)
    local = agreed(C.read_framed_range, path, codec, start, stop, n_threads=n_threads)
    return flagstat_multihost(local, total_words=sum(words), impl=impl,
                              pad_to_words=max(words), device=device)


def _agree(err: Exception | None, leg: str) -> None:
    """Return once every rank's local step is known to have succeeded. A
    rank that failed (``err``) sends ok=0 instead of raising, so the
    others are not left waiting in a collective; then every rank
    raises, the failed one with its own error."""
    failed = np.flatnonzero(_allgather_i64(np.array([err is not None]))[:, 0])
    if failed.size:
        if err is not None:
            raise err
        raise ValueError(f"{leg}: the walk failed on rank(s) {failed.tolist()}")


def flagstat_multihost_bgzf_sam(path, n_threads: int = 0, impl: str | None = None,
                                device=None) -> np.ndarray:
    """Multi-process flagstat of one BGZF-compressed SAM (`bgzip x.sam`).

    Each rank scans the BGZF member chain (headers only, no inflate) and
    takes its contiguous member range; line ownership is exact at range
    boundaries (io/csrc/sam_reader.cpp bgzf_sam_walk). ``impl=None``
    reads the range's FLAG column (io/samio.read_sam_flags_range, split
    again over in-process sub-ranges where the range is large enough)
    and counts it on ``device`` through ``flagstat_multihost`` (default:
    the card; with no card and no ``device`` every rank raises before
    reading). ``impl="native"``: the fused host range walkers count the
    range and only the 32 counters cross ranks. Errors are agreed on
    before anything is counted."""
    from ..io.samio import (_flagstat_bgzf_sam_parallel, bgzf_member_count,
                            flagstat_sam_range, read_sam_flags_range)

    if impl is None:
        impl = D.device_impl(device)
    size, rank = _world()
    start, stop = C.shard_block_ranges(bgzf_member_count(path), size)[rank]
    local, err = None, None
    try:
        if impl == "native":
            local = _flagstat_bgzf_sam_parallel(path, threads=n_threads, member_start=start,
                                                member_stop=stop)
            if local is None:
                local = flagstat_sam_range(path, start, stop, threads=n_threads)
        else:
            local = read_sam_flags_range(path, start, stop, threads=n_threads)
    except ValueError as e:
        err = e
    _agree(err, "flagstat_multihost_bgzf_sam")
    if impl == "native":
        return _global_counter_sum(local)
    return flagstat_multihost(local, impl=impl, device=device)


def flagstat_multihost_bam(path, n_threads: int = 0, impl: str | None = None,
                           device=None) -> np.ndarray:
    """Multi-process flagstat of one BAM.

    BAM records are self-delimited with no resync marker, so each rank
    enters its inflated-byte range by the arrival-exact resync walk
    (io/csrc/bam_reader.cpp, the machinery of the single-host
    lfs_bam_flagstat_parallel): rank p walks [total*p/P, total*(p+1)/P)
    from the first structurally validated record boundary and reports
    where its chain landed. ``impl=None`` reads the range's FLAG column
    (io/bamio.read_bam_flags_byte_range) to count it on ``device``
    (default: the card; with no card and no ``device`` every rank
    raises before reading); ``impl="native"`` fused-counts the range on
    the host. Every rank then takes part in the same collectives, in
    order: (1) the allgather of (ok, start, end); (2) the chain check:
    end_p == start_{p+1}, the last rank's end is the end of the
    inflated stream; (3) one count over ranks, ``flagstat_multihost``
    of the columns (``_global_counter_sum`` of the native counters).
    Any break, or a failed resync, falls back to rank 0 reading the
    whole file (``read_bam_flags``; ``flagstat_bam(impl="native")`` for
    ``impl="native"``) while the rest pass nothing, so the global
    counters are exact either way; an error of that read is agreed on
    before (3)."""
    from ..io.bamio import (bam_raw_size, flagstat_bam, flagstat_bam_byte_range,
                            read_bam_flags, read_bam_flags_byte_range)

    if impl is None:
        impl = D.device_impl(device)
    native = impl == "native"
    total = bam_raw_size(path)
    size, rank = _world()
    lo, hi = total * rank // size, total * (rank + 1) // size
    try:
        res = (flagstat_bam_byte_range(path, lo, hi, threads=n_threads) if native
               else read_bam_flags_byte_range(path, lo, hi, threads=n_threads))
    except ValueError:
        # a local error must still reach the allgather below as ok=0:
        # raising here would leave the other ranks hung in the collective
        res = None
    empty = np.zeros(F.N_COUNTERS, np.uint64) if native else np.zeros(0, np.uint16)
    ok, local, start, end = (0, empty, 0, 0) if res is None else (1, res[0], res[-2], res[-1])
    meta = _allgather_i64(np.array([ok, start, end], dtype=np.int64))
    chain_ok = bool((meta[:, 0] == 1).all()) and meta[size - 1, 2] == total and \
        all(meta[p, 2] == meta[p + 1, 1] for p in range(size - 1))
    if not chain_ok:
        local, err = empty, None
        if rank == 0:
            try:
                local = (np.asarray(flagstat_bam(path, threads=n_threads, impl="native"),
                                    dtype=np.uint64) if native
                         else read_bam_flags(path, threads=n_threads))
            except ValueError as e:
                err = e
        _agree(err, "flagstat_multihost_bam")
    if native:
        return _global_counter_sum(local)
    return flagstat_multihost(local, impl=impl, device=device)


def flagstat_multihost_cram(path, n_threads: int = 0, impl: str | None = None,
                            device=None) -> np.ndarray:
    """Multi-process flagstat of one CRAM.

    Containers are self-describing and independent, so each rank walks
    the header chain (seek-only, a few dozen bytes per container; no
    resync, unlike BAM) and counts its contiguous container range with
    io/cramio.flagstat_cram_range, routed as there: ``impl=None`` reads
    the range's column (the container column reader, cram_columns.cpp)
    and counts it on ``device`` (default: the card;
    with no card and no ``device`` every rank raises before reading),
    ``impl="native"`` the fused range walker. Only the 32 counters
    cross ranks."""
    from ..io.cramio import data_container_count, flagstat_cram_range

    if impl is None:
        D.device_impl(device)   # no card and no device: raise before reading
    size, rank = _world()
    start, stop = C.shard_block_ranges(data_container_count(path), size)[rank]
    local, err = None, None
    try:
        local = flagstat_cram_range(path, start, stop, threads=n_threads, impl=impl,
                                    device=device)
    except ValueError as e:
        err = e
    _agree(err, "flagstat_multihost_cram")
    return _global_counter_sum(local)


def scaling_sweep(n_words: int = 1 << 24, impl: str | None = None, device_counts=None,
                  iters: int = 3, devices=None) -> list[dict]:
    """flags/s of the sharded count at increasing device counts
    (BASELINE.json config #5): for each count nd, the column, resident on
    the first device, split over the first nd entries of ``devices``
    (default every CUDA device; entries may repeat, e.g. ``["cpu"] * 2``)
    and timed per call with ``bench.harness.kernel_time`` on the first
    device (CUDA events there; the merge onto it waits for every shard).
    The counters are checked against the host oracle before any timing.
    ``impl``: a sharded impl, default ``"cuda"`` (``"torch"`` when the
    first device is the CPU)."""
    from ..bench.harness import kernel_time
    from ..oracle import flagstat_numpy, generate_flags

    devs = data_devices(devices)
    if impl is None:
        impl = D.device_impl(devs[0])
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devs)]
    x_host = generate_flags(n_words, seed=0, full_range=True)
    ref = flagstat_numpy(x_host)
    x = as_words(x_host).to(devs[0])
    results = []
    for nd in device_counts:
        sub = devs[:nd]
        total, fail = sharded_sums(x, sub, impl)
        got = assemble_counters(total, fail, n_words).cpu().numpy().astype(np.uint64)
        if not (got == ref).all():
            raise AssertionError(f"sharded counters on {nd} devices != oracle: {got} {ref}")
        best = kernel_time(lambda a: torch.cat(sharded_sums(a, sub, impl)), x,
                           iters=iters, device=sub[0])
        results.append({"devices": nd, "words_per_s": n_words / best, "min_s": best})
    base = results[0]["words_per_s"]
    for r in results:
        r["scaling_efficiency"] = r["words_per_s"] / (base * r["devices"])
    return results

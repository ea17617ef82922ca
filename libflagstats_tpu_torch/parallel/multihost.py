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
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import flags as F
from ..io import codec as C
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
    impl, or None for ``ops.dispatch.auto_impl`` on that device."""
    local = D._validate_u16(local_flags)
    dev = _local_device(device)
    if impl is None:
        impl = D.auto_impl(len(local), dev)
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

    Each rank scans the frame index (headers only), decodes its
    contiguous block range, counts it on its device and the sums merge
    over ranks (the reference's sequential block loop,
    flagstats.cpp:311-332, spread across processes).

    ``impl="native"``, asked for by name: each rank runs the fused C++
    decode+count over its byte range, and only the 32 counters cross
    processes. ``impl=None`` counts on the device (ops.dispatch.auto_impl)."""
    frames = C.scan_frames(path)
    size, rank = _world()
    ranges = C.shard_block_ranges(len(frames), size)
    start, stop = ranges[rank]
    if impl == "native":
        local, _ = native_host.flagstat_framed_range_native(
            path, C._codec_id(codec), start, stop, threads=n_threads, frames=frames)
        return _global_counter_sum(local)
    words = [sum(r for _, r, _ in frames[a:b]) // 2 for a, b in ranges]
    local = C.read_framed_range(path, codec, start, stop, n_threads=n_threads)
    return flagstat_multihost(local, total_words=sum(words), impl=impl,
                              pad_to_words=max(words), device=device)

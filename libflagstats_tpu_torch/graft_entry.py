"""Entry points of the port for an outside harness: one flagstat step,
and a dry run of the data-parallel step over n shards.

The counterparts of ``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip``, kept in the package:

``entry(device=None)`` -> ``(fn, (x,))``: ``fn(x)`` is one flagstat
    step on the kernel path, K1 (``ops/kernels.flagstat_cuda``) over
    ``x``, the 524,288 words of ``generate_flags(8 * GROUP_WORDS,
    seed=0)`` (one Pallas grid step of the JAX entry) resident on the
    card; ``device="cpu"`` takes the torch tier on the CPU.
``dryrun_multichip(n, devices=None)``: the JAX function's three legs
    over ``n`` shards, each held against ``flagstat_numpy``: three
    accumulated steps (the third with an uneven tail) of the merged
    per-shard stream sums with the derived pass total applied once per
    step after the merge (``parallel.sharded.sharded_sums`` and
    ``assemble_counters``; the JAX leg's ``psum`` in ``shard_map``),
    then ``flagstat_sharded`` with ``impl="cuda"`` (K1) and
    ``impl="cuda_pre"`` (host transpose, then K2) on n x 8 x 65,536 -
    12,345 words. ``devices=None`` puts the n shards round-robin on the
    cards present (entries may repeat: one card can hold several);
    ``devices=["cpu"] * n`` runs every leg on the torch tier (the two
    sharded legs are then one).

Both raise with no card unless the CPU is asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import dispatch as D
from .ops import kernels as K
from .ops.torch_ops import as_words, assemble_counters, flagstat_torch
from .oracle import flagstat_numpy, generate_flags

#: words of one shard in the accumulated steps (the JAX dryrun's)
WORDS_PER_SHARD = 4096
#: the ragged tail cut off the sharded legs' n x 8 groups
SHARDED_TAIL = 12_345


def entry(device=None):
    """``(fn, (x,))``: ``fn(x)`` -> (32,) int64 flagstat counters of x on
    its device (K1 on the card; the torch tier with ``device="cpu"``)."""
    D.auto_impl(0, device)   # no card and no device asked for: raise
    dev = torch.device("cuda" if device is None else device)
    n = 8 * K.GROUP_WORDS
    x = as_words(generate_flags(n, seed=0)).to(dev)

    if dev.type == "cuda":
        def fn(flags_batch):
            return K.flagstat_cuda(flags_batch, n=n)
    else:
        def fn(flags_batch):
            return flagstat_torch(flags_batch, n=n)

    return fn, (x,)


def _shard_devices(n_devices: int, devices) -> list[torch.device]:
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if devices is None:
        D.auto_impl(0, None)   # no card: raise
        cards = torch.cuda.device_count()
        return [torch.device("cuda", i % cards) for i in range(n_devices)]
    devs = [torch.device(d) for d in devices]
    if len(devs) != n_devices:
        raise ValueError(f"{len(devs)} devices given for {n_devices} shards")
    return devs


def _check(got, want: np.ndarray, leg: str) -> None:
    got = np.asarray(got, dtype=np.int64)
    if not (got == want).all():
        raise AssertionError(f"dryrun_multichip {leg}: {got.tolist()} != {want.tolist()}")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the three legs over ``n_devices`` shards and print one line a
    leg; raises AssertionError on a counter that differs from the
    oracle."""
    from .parallel.sharded import flagstat_sharded, sharded_sums

    devs = _shard_devices(n_devices, devices)
    on_cpu = all(d.type == "cpu" for d in devs)
    where = ("torch tier on the CPU" if on_cpu
             else "cards " + ",".join(sorted({str(d) for d in devs})))

    # three steps, the last with an uneven zero-padded tail: the merged
    # stream sums of every shard, then the counters of the step's true
    # length added to the running total
    n_words = n_devices * WORDS_PER_SHARD
    counters = torch.zeros(32, dtype=torch.int64, device=devs[0])
    consumed = []
    for i, tail in enumerate((0, 0, WORDS_PER_SHARD // 3)):
        n_true = n_words - tail
        batch = np.zeros(n_words, dtype=np.uint16)
        chunk = generate_flags(n_true, seed=10 + i)
        batch[:n_true] = chunk
        consumed.append(chunk)
        total, fail = sharded_sums(as_words(batch), devs, "torch" if on_cpu else "cuda")
        counters += assemble_counters(total, fail, n_true)
    _check(counters.cpu(), flagstat_numpy(np.concatenate(consumed)).astype(np.int64),
           "accumulated steps")
    print(f"dryrun_multichip OK on {n_devices} shards ({where}) [local kernel "
          f"{'torch' if on_cpu else 'cuda (K1)'} + merge]: 3 accumulated steps (uneven tail) "
          f"match oracle")

    n_sharded = n_devices * 8 * K.GROUP_WORDS - SHARDED_TAIL
    xp = generate_flags(n_sharded, seed=99, full_range=True)
    want = flagstat_numpy(xp).astype(np.int64)
    legs = ((("torch", "torch"),) if on_cpu else
            (("cuda", "cuda (K1)"), ("cuda_pre", "cuda_pre (host transpose + K2)")))
    for impl, label in legs:
        _check(flagstat_sharded(xp, devices=devs, impl=impl), want, impl)
        print(f"dryrun_multichip OK on {n_devices} shards ({where}) [flagstat_sharded, local "
              f"kernel {label} + merge]: {n_sharded} words (uneven tail) match oracle")

"""The reference ``flagstat_shards``: the 32 flagstat counters of a FLAG
column held as a list of shards, each on its own device.

The counters are linear in the histogram of word values, and a column's
histogram is the sum of its shards'. So each shard's int64 histogram is
taken on the device it lies on (``torch.bincount`` in blocks), the
histograms are summed, and the sum is multiplied by the 65,536 x 32
table of each value's counters. The table is the ``flagstat``
reference's, written from samtools' flagstat rules; a reference imports
nothing beyond torch and numpy, so it is copied here, and
``cardbench/tests/test_cardbench_sharded.py`` holds the two equal. The
control does the same in float32, the step below exact integer counts,
as ``flagstat``'s does.
"""
from __future__ import annotations

import numpy as np
import torch

N_COUNTERS = 32
BLOCK_WORDS = 1 << 26


def value_table() -> np.ndarray:
    """(65536, 32) int64: the counters of a column holding one word of
    each value, by the samtools rules (the ``flagstat`` reference's)."""
    v = np.arange(1 << 16, dtype=np.int64) & 0x0FFF

    def bit(k):
        return (v >> k) & 1

    paired, proper, unmap, munmap = bit(0), bit(1), bit(2), bit(3)
    reverse, mreverse, read1, read2 = bit(4), bit(5), bit(6), bit(7)
    secondary, qcfail, dup, supp = bit(8), bit(9), bit(10), bit(11)
    pair_branch = paired & (1 - secondary) & (1 - supp)
    mapped_pair = pair_branch & (1 - unmap)
    events = np.zeros((v.size, 16), dtype=np.int64)
    events[:, 0] = pair_branch
    events[:, 1] = pair_branch & proper
    events[:, 2] = unmap
    events[:, 3] = pair_branch & munmap
    events[:, 4] = pair_branch & reverse
    events[:, 5] = pair_branch & mreverse
    events[:, 6] = pair_branch & read1
    events[:, 7] = pair_branch & read2
    events[:, 8] = secondary
    events[:, 9] = qcfail
    events[:, 10] = dup
    events[:, 11] = supp & (1 - secondary)
    events[:, 12] = mapped_pair & proper
    events[:, 13] = mapped_pair & munmap
    events[:, 14] = mapped_pair & (1 - munmap)
    table = np.zeros((v.size, N_COUNTERS), dtype=np.int64)
    passed = qcfail == 0
    table[passed, :16] = events[passed]
    table[~passed, 16:] = events[~passed]
    table[:, 9] = 1 - qcfail        # the QC-pass read total
    return table


def _histogram(shard: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(65536,) counts of each word value of an int16 ``shard``, on its
    device, in ``dtype`` (int64; float32 for the control, a histogram of
    float32 weights)."""
    hist = torch.zeros(1 << 16, dtype=dtype, device=shard.device)
    for s in range(0, shard.shape[0], BLOCK_WORDS):
        part = shard[s:s + BLOCK_WORDS].to(torch.int32) & 0xFFFF
        weights = None if dtype == torch.int64 else torch.ones(part.shape[0], dtype=dtype,
                                                              device=shard.device)
        hist += torch.bincount(part, weights=weights, minlength=1 << 16)
    return hist


def exact(shards, device) -> np.ndarray:
    """(32,) int64: the exact counters of the column the shards hold."""
    hist = np.zeros(1 << 16, dtype=np.int64)
    for s in shards:
        hist += _histogram(s, torch.int64).cpu().numpy()
    return hist @ value_table()


def control(shards, device) -> np.ndarray:
    """The control: float32 histograms of the shards on their devices,
    summed in float32 on the first shard's, times the float32 table,
    rounded back to int64."""
    first = shards[0].device
    hist = torch.zeros(1 << 16, dtype=torch.float32, device=first)
    for s in shards:
        hist += _histogram(s, torch.float32).to(first)
    table = torch.from_numpy(value_table().astype(np.float32)).to(first)
    return torch.round(hist @ table).to(torch.int64).cpu().numpy()

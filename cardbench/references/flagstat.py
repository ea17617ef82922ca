"""The reference ``flagstat``: the 32 flagstat counters of a FLAG column.

Written from the counters' definition, not from the program: counters
0-15 count, for QC-pass reads, each bit of the word that samtools'
flagstat walk would act on; 16-31 do the same for QC-fail reads; counter
9 holds the number of QC-pass reads and counter 25 that of QC-fail
reads. Bits 12-14 are the synthesized "properly paired", "singleton" and
"both mates mapped" of a mapped read in the pair branch (paired, neither
secondary nor supplementary); bits 12-15 of a raw word are ignored.

The counters are linear in the column's histogram of word values, so
the reference takes the histogram in blocks (``torch.bincount``, int64)
and multiplies it by a 65,536 x 32 table of each value's counters. The
control does the same in float32, the step below exact integer counts.
Imports torch and numpy only.
"""
from __future__ import annotations

import numpy as np
import torch

N_COUNTERS = 32
BLOCK_WORDS = 1 << 26


def value_table() -> np.ndarray:
    """(65536, 32) int64: the counters of a column holding one word of
    each value, by the samtools rules."""
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


def _blocks(column, device):
    """int32 word values of ``column`` (a torch int16 tensor or a numpy
    uint16 array) block by block, on ``device``."""
    n = column.shape[0]
    for s in range(0, n, BLOCK_WORDS):
        part = column[s:s + BLOCK_WORDS]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(part.view(np.int16))
        yield part.to(device).to(torch.int32) & 0xFFFF


def histogram(column, device) -> np.ndarray:
    """(65536,) int64 counts of each word value."""
    hist = torch.zeros(1 << 16, dtype=torch.int64, device=device)
    for part in _blocks(column, device):
        hist += torch.bincount(part, minlength=1 << 16)
    return hist.cpu().numpy()


def exact(column, device) -> np.ndarray:
    """(32,) int64: the exact counters of ``column``."""
    return histogram(column, device) @ value_table()


def control(column, device) -> np.ndarray:
    """The control: the same sum with float32 counts (a histogram of
    float32 weights, a float32 product), rounded back to int64."""
    hist = torch.zeros(1 << 16, dtype=torch.float32, device=device)
    for part in _blocks(column, device):
        hist += torch.bincount(part, weights=torch.ones(part.shape[0], dtype=torch.float32,
                                                        device=device),
                               minlength=1 << 16)
    table = torch.from_numpy(value_table().astype(np.float32)).to(device)
    return torch.round(hist @ table).to(torch.int64).cpu().numpy()

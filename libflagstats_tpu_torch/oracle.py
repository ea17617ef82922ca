"""Golden-standard flagstat oracles (NumPy, host-side).

Two independent implementations:

* :func:`flagstat_loop` — a direct per-word transcription of the samtools
  branchy update (reference: FLAGSTAT_scalar_update, libflagstats.h:118-142).
  Slow; used as the root of trust in tests.
* :func:`flagstat_numpy` — a vectorized NumPy implementation of the
  mask-select propagate-carry formulation the device kernels use
  (reference: libflagstats.h:234-290). Fast; doubles as the host oracle
  for large differential tests.

Both return the 32-counter vector described in :mod:`libflagstats_tpu_torch.flags`.
A copy of ``libflagstats_tpu.oracle`` (numpy only, so the port imports no
jax); tests/test_torch_modules.py holds the two equal.
By default they apply the SIMD-kernel convention for counter 9
(pass-stratum total = len - n_fail, reference: libflagstats.h:429); the
reference *scalar* path leaves that counter at 0 — pass
``derive_pass_total=False`` to reproduce that behavior.
"""
from __future__ import annotations

import numpy as np

from . import flags as F


def _as_u16(array) -> np.ndarray:
    arr = np.asarray(array)
    if arr.dtype != np.uint16:
        raise ValueError(f"FLAG array must be uint16, got {arr.dtype}")
    return np.ascontiguousarray(arr).ravel()


def flagstat_loop(array, out=None, derive_pass_total: bool = True,
                  count_paired: bool = False) -> np.ndarray:
    """Per-word branchy oracle (reference: libflagstats.h:118-142).

    Accumulates into ``out`` if given (the reference kernels' streaming
    contract: callers may pass one counter vector across many blocks).

    ``count_paired``: the reference scalar leaves samtools' n_pair_all
    count commented out (libflagstats.h:131), so counter 0 stays 0 by
    default for scalar-path fidelity; pass True to fill it like the
    vector kernels (and samtools itself) do — required when the result
    feeds a report, whose paired-in-sequencing line and percentage
    denominators read counter 0.
    """
    arr = _as_u16(array)
    counters = np.zeros(F.N_COUNTERS, dtype=np.uint64) if out is None else out
    n_fail_before = int(counters[F.FQCFAIL_OFF + 16])
    for val in arr.tolist():
        offset = 16 if (val & F.FQCFAIL) else 0
        f = offset
        if offset:
            counters[f + F.FQCFAIL_OFF] += 1
        if val & F.FSECONDARY:
            counters[f + F.FSECONDARY_OFF] += 1
        elif val & F.FSUPPLEMENTARY:
            counters[f + F.FSUPPLEMENTARY_OFF] += 1
        elif val & F.FPAIRED:
            if count_paired:
                counters[f + F.FPAIRED_OFF] += 1
            if (val & F.FPROPER_PAIR) and not (val & F.FUNMAP):
                counters[f + F.BIT12_OFF] += 1
            if val & F.FREAD1:
                counters[f + F.FREAD1_OFF] += 1
            if val & F.FREAD2:
                counters[f + F.FREAD2_OFF] += 1
            if (val & F.FMUNMAP) and not (val & F.FUNMAP):
                counters[f + F.BIT13_OFF] += 1
            if not (val & F.FUNMAP) and not (val & F.FMUNMAP):
                counters[f + F.BIT14_OFF] += 1
        if val & F.FUNMAP:
            counters[f + F.FUNMAP_OFF] += 1
        if val & F.FDUP:
            counters[f + F.FDUP_OFF] += 1
    if derive_pass_total:
        n_fail = int(counters[F.FQCFAIL_OFF + 16]) - n_fail_before
        counters[F.FQCFAIL_OFF] += len(arr) - n_fail
    return counters


def transform_words(arr: np.ndarray) -> np.ndarray:
    """Mask-select propagate-carry transform, word space (NumPy).

    Maps each raw FLAG word to a word whose set bits are exactly the
    positional events flagstat counts (reference: LOAD macro chain
    O1/O2/O3 then L1/L2/L3, libflagstats.h:281-290):

    * bits in KEEP_ALWAYS (UNMAP, SEC, QCFAIL, DUP) pass through;
    * bits in PAIR_BRANCH_MASK survive iff paired & ~sec & ~sup;
    * bit 11 (SUPPLEMENTARY) survives iff sup & ~sec;
    * bits 12/13/14 are synthesized properly-paired / singleton /
      both-mapped indicators, gated on the pair branch;
    * input bits 12-15 are ignored.
    """
    x = arr.astype(np.uint32) & np.uint32(F.INPUT_MASK)
    pair = x & np.uint32(F.FPAIRED)
    sec = (x >> F.FSECONDARY_OFF) & np.uint32(1)
    sup = (x >> F.FSUPPLEMENTARY_OFF) & np.uint32(1)
    unmap = (x >> F.FUNMAP_OFF) & np.uint32(1)
    munmap = (x >> F.FMUNMAP_OFF) & np.uint32(1)
    proper = (x >> F.FPROPER_PAIR_OFF) & np.uint32(1)

    inpair = pair & (sec ^ 1) & (sup ^ 1)
    supc = sup & (sec ^ 1)
    im = inpair & (unmap ^ 1)          # pair branch & mapped
    b12 = im & proper
    b13 = im & munmap
    b14 = im ^ b13                      # im & ~munmap

    pair_mask = inpair * np.uint32(0xFFFF)
    t = (x & np.uint32(F.KEEP_ALWAYS)) | (x & np.uint32(F.PAIR_BRANCH_MASK) & pair_mask)
    t |= supc << F.FSUPPLEMENTARY_OFF
    t |= (b12 << F.BIT12_OFF) | (b13 << F.BIT13_OFF) | (b14 << F.BIT14_OFF)
    return t


def flagstat_numpy(array, out=None, derive_pass_total: bool = True) -> np.ndarray:
    """Vectorized oracle: transform + positional popcount per QC stratum."""
    arr = _as_u16(array)
    counters = np.zeros(F.N_COUNTERS, dtype=np.uint64) if out is None else out
    t = transform_words(arr)
    qc = (t & np.uint32(F.FQCFAIL)) != 0
    tf = t[qc]
    tp = t[~qc]
    for k in range(F.N_BITS):
        counters[k] += np.count_nonzero((tp >> k) & 1)
        counters[16 + k] += np.count_nonzero((tf >> k) & 1)
    # pass-stratum bit 9 is always zero in the transformed pass words;
    # the pass-read total is derived (reference: libflagstats.h:429).
    if derive_pass_total:
        counters[F.FQCFAIL_OFF] += len(tp)
    return counters


def generate_flags(n: int, seed: int = 0, full_range: bool = False) -> np.ndarray:
    """Synthetic FLAG vectors (reference: benchmark/generate.cpp:7-18 draws
    uniform [0, 4096); the instrumented benchmark draws full 16-bit words)."""
    rng = np.random.default_rng(seed)
    hi = 0x10000 if full_range else 0x1000
    return rng.integers(0, hi, size=n, dtype=np.uint16)

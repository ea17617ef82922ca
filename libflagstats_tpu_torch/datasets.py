"""Synthetic conformance datasets.

The reference validates end-to-end against the NA12878D_HiSeqX_R12
flagstat report (reference: README.md:177-196). This environment has no
network access to the 100+GB BAM, so :func:`synth_na12878` constructs a
FLAG multiset whose flagstat report *provably* equals the published
numbers (scaled by ``1/scale_divisor``): each report line is realized by
an explicit category of FLAG words, and the category sizes are derived
from the published report by the same arithmetic identities samtools
uses. At ``scale_divisor=1`` the expected counters are exactly the
published NA12878 values (asserted in tests).

Published NA12878 pass-stratum values (reference: README.md:179-196;
QC-fail column is all zero):
  total 824,541,892; secondary 0; supplementary 5,393,628; duplicates 0;
  mapped 805,383,403; paired in sequencing 819,148,264;
  read1 = read2 = 409,574,132; properly paired 781,085,884;
  with itself and mate mapped 797,950,890; singletons 2,038,885.

A copy of ``libflagstats_tpu.datasets`` (numpy only, so the port imports
no jax); tests/test_torch_modules.py holds the two byte-identical.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import flags as F

NA12878_PUBLISHED = {
    "total": 824_541_892,
    "secondary": 0,
    "supplementary": 5_393_628,
    "duplicates": 0,
    "mapped": 805_383_403,
    "paired_in_sequencing": 819_148_264,
    "read1": 409_574_132,
    "read2": 409_574_132,
    "properly_paired": 781_085_884,
    "both_mapped": 797_950_890,
    "singletons": 2_038_885,
}


@dataclass(frozen=True)
class FlagCategory:
    """A FLAG word template and how many words carry it."""

    flag: int
    count: int


def na12878_categories(scale_divisor: int = 1) -> list[FlagCategory]:
    """Decompose the published report into FLAG categories.

    Derivation (all from NA12878_PUBLISHED, checked for consistency):
      unpaired          = total - paired = supplementary  (all supp, mapped)
      pair_both_mapped  = both_mapped  (proper subset of it)
      pair_not_proper   = both_mapped - properly_paired
      pair_self_unmap   = paired - both_mapped - singletons
      read1/read2 split balances the read1 = read2 totals exactly.
    """
    p = NA12878_PUBLISHED
    assert p["total"] - p["paired_in_sequencing"] == p["supplementary"]
    assert p["mapped"] - p["both_mapped"] - p["singletons"] == p["supplementary"]

    proper = p["properly_paired"]
    notproper = p["both_mapped"] - proper
    sgl = p["singletons"]
    self_unmap = p["paired_in_sequencing"] - p["both_mapped"] - sgl

    # read1 share after proper/notproper are split evenly
    r1_rest = p["read1"] - proper // 2 - notproper // 2
    sgl_r1 = sgl // 2
    unm_r1 = r1_rest - sgl_r1
    unm_r2 = self_unmap - unm_r1
    sgl_r2 = sgl - sgl_r1
    assert p["read2"] == (proper - proper // 2) + (notproper - notproper // 2) \
        + sgl_r2 + unm_r2

    P, PP, U, MU, R1, R2, SUP = (
        F.FPAIRED, F.FPROPER_PAIR, F.FUNMAP, F.FMUNMAP, F.FREAD1, F.FREAD2,
        F.FSUPPLEMENTARY,
    )
    cats = [
        FlagCategory(SUP, p["supplementary"]),
        FlagCategory(P | PP | R1, proper // 2),
        FlagCategory(P | PP | R2, proper - proper // 2),
        FlagCategory(P | R1, notproper // 2),
        FlagCategory(P | R2, notproper - notproper // 2),
        FlagCategory(P | MU | R1, sgl_r1),
        FlagCategory(P | MU | R2, sgl_r2),
        FlagCategory(P | U | MU | R1, unm_r1),
        FlagCategory(P | U | MU | R2, unm_r2),
    ]
    if scale_divisor > 1:
        cats = [FlagCategory(c.flag, c.count // scale_divisor) for c in cats]
    return cats


def synth_na12878(scale_divisor: int = 1, seed: int = 0,
                  shuffle: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Generate the synthetic NA12878 FLAG column.

    Returns (flags_u16, expected_counters[32]) where the expectation is
    derived from the category construction (independent of any counting
    implementation). REVERSE/MREVERSE bits are randomized onto EVERY
    word (mapped or not) — they don't enter the report, and because the
    randomization makes the positional counts at positions 4/5 (and
    their fail-stratum mirrors) data-dependent, expected[4]/expected[5]
    are returned as 0 and must be excluded from (or recomputed for) any
    full-32-counter comparison.
    """
    cats = na12878_categories(scale_divisor)
    parts = [np.full(c.count, c.flag, dtype=np.uint16) for c in cats]
    arr = np.concatenate(parts) if parts else np.zeros(0, np.uint16)

    rng = np.random.default_rng(seed)
    rev = rng.integers(0, 4, size=arr.size, dtype=np.uint16) << F.FREVERSE_OFF
    arr = arr | rev
    if shuffle:
        rng.shuffle(arr)

    expected = np.zeros(F.N_COUNTERS, dtype=np.uint64)
    for c in cats:
        t = int(_transform_word(c.flag))
        for k in range(F.N_BITS):
            if (t >> k) & 1:
                expected[k] += c.count
    # REVERSE/MREVERSE positional counts are random; mark via recompute
    total = sum(c.count for c in cats)
    expected[F.FREVERSE_OFF] = 0   # filled by caller if needed
    expected[F.FMREVERSE_OFF] = 0
    expected[F.FQCFAIL_OFF] = total      # derived pass total (no QC-fail)
    return arr, expected


def _transform_word(val: int) -> int:
    """Scalar word transform (mirrors oracle.transform_words for one word)."""
    from .oracle import transform_words

    return int(transform_words(np.array([val], dtype=np.uint16))[0])


def na12878_report_values(scale_divisor: int = 1) -> dict:
    """The expected flagstat report of the synthetic dataset."""
    cats = na12878_categories(scale_divisor)

    def n(pred):
        return sum(c.count for c in cats if pred(c.flag))

    total = sum(c.count for c in cats)
    return {
        "total": total,
        "secondary": 0,
        "supplementary": n(lambda f: f & F.FSUPPLEMENTARY),
        "duplicates": 0,
        "mapped": n(lambda f: not (f & F.FUNMAP)),
        "paired_in_sequencing": n(lambda f: f & F.FPAIRED),
        "read1": n(lambda f: (f & F.FPAIRED) and (f & F.FREAD1)),
        "read2": n(lambda f: (f & F.FPAIRED) and (f & F.FREAD2)),
        "properly_paired": n(
            lambda f: (f & F.FPAIRED) and (f & F.FPROPER_PAIR) and not (f & F.FUNMAP)
        ),
        "both_mapped": n(
            lambda f: (f & F.FPAIRED) and not (f & F.FUNMAP) and not (f & F.FMUNMAP)
        ),
        "singletons": n(
            lambda f: (f & F.FPAIRED) and (f & F.FMUNMAP) and not (f & F.FUNMAP)
        ),
    }

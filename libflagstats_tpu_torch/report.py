"""Counter-vector -> samtools flagstat report mapping.

Reference: benchmark/flagstats.cpp:578-590 (report printer) and
python/libflagstats.pyx:24-36 (binding dict). The "mate mapped to a
different chr" lines are intentionally absent: they are not derivable
from the FLAG column alone (reference: benchmark/flagstats.cpp:589-590).

A copy of ``libflagstats_tpu.report`` (numpy only, so the port imports no
jax); tests/test_torch_modules.py holds the two equal.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import flags as F


@dataclass(frozen=True)
class FlagstatReport:
    """The samtools flagstat summary, split pass/fail per line."""

    total: tuple[int, int]
    secondary: tuple[int, int]
    supplementary: tuple[int, int]
    duplicates: tuple[int, int]
    mapped: tuple[int, int]
    paired_in_sequencing: tuple[int, int]
    read1: tuple[int, int]
    read2: tuple[int, int]
    properly_paired: tuple[int, int]
    both_mapped: tuple[int, int]
    singletons: tuple[int, int]

    def lines(self) -> list[str]:
        def pct(num, den):
            return "N/A" if den == 0 else f"{100.0 * num / den:.2f}%"

        p, f = self.total
        mp, mf = self.mapped
        pp, pf = self.properly_paired
        sp, sf = self.singletons
        # samtools (and the reference printer, benchmark/flagstats.cpp:
        # percent(n_pair_good, n_pair_all) / percent(n_sgltn, n_pair_all))
        # use paired-in-sequencing as the denominator for the
        # properly-paired and singleton percentage columns; only the
        # mapped line is a fraction of the stratum total.
        qp, qf = self.paired_in_sequencing
        return [
            f"{p} + {f} in total (QC-passed reads + QC-failed reads)",
            f"{self.secondary[0]} + {self.secondary[1]} secondary",
            f"{self.supplementary[0]} + {self.supplementary[1]} supplementary",
            f"{self.duplicates[0]} + {self.duplicates[1]} duplicates",
            f"{mp} + {mf} mapped ({pct(mp, p)} : {pct(mf, f)})",
            f"{self.paired_in_sequencing[0]} + {self.paired_in_sequencing[1]} paired in sequencing",
            f"{self.read1[0]} + {self.read1[1]} read1",
            f"{self.read2[0]} + {self.read2[1]} read2",
            f"{pp} + {pf} properly paired ({pct(pp, qp)} : {pct(pf, qf)})",
            f"{self.both_mapped[0]} + {self.both_mapped[1]} with itself and mate mapped",
            f"{sp} + {sf} singletons ({pct(sp, qp)} : {pct(sf, qf)})",
        ]

    def text(self) -> str:
        return "\n".join(self.lines())


def counters_to_report(counters) -> FlagstatReport:
    """Map the 32-counter vector to the flagstat report.

    Reference mapping (benchmark/flagstats.cpp:578-590):
      total       = c[9] / c[25]           (pass-total is the derived counter)
      mapped      = total - c[2] / c[18]   (UNMAP)
      secondary   = c[8] / c[24]; supplementary = c[11] / c[27]
      duplicates  = c[10] / c[26]; paired = c[0] / c[16]
      read1/read2 = c[6], c[7] (+16); properly paired = c[12] (+16)
      both mapped = c[14] (+16); singletons = c[13] (+16)
    """
    c = np.asarray(counters)
    if c.shape != (F.N_COUNTERS,):
        raise ValueError(f"expected shape ({F.N_COUNTERS},), got {c.shape}")

    def pf(off):
        return (int(c[off]), int(c[off + 16]))

    total_p, total_f = pf(F.FQCFAIL_OFF)
    unmap_p, unmap_f = pf(F.FUNMAP_OFF)
    return FlagstatReport(
        total=(total_p, total_f),
        secondary=pf(F.FSECONDARY_OFF),
        supplementary=pf(F.FSUPPLEMENTARY_OFF),
        duplicates=pf(F.FDUP_OFF),
        mapped=(total_p - unmap_p, total_f - unmap_f),
        paired_in_sequencing=pf(F.FPAIRED_OFF),
        read1=pf(F.FREAD1_OFF),
        read2=pf(F.FREAD2_OFF),
        properly_paired=pf(F.BIT12_OFF),
        both_mapped=pf(F.BIT14_OFF),
        singletons=pf(F.BIT13_OFF),
    )


def counters_to_dict(counters, n_values: int) -> dict:
    """pyflagstats-compatible dict (reference: python/libflagstats.pyx:24-36)."""
    c = np.asarray(counters)
    passed = dict(zip(F.SAM_FLAG_NAMES, (int(v) for v in c[0:15])))
    failed = dict(zip(F.SAM_FLAG_NAMES, (int(v) for v in c[16:31])))
    out = {"n_values": n_values, "passed": passed, "failed": failed}
    out["passed"]["mapped"] = n_values - passed["FUNMAP"] - failed["FUNMAP"]
    out["passed"]["paired_in_seq"] = passed["FREAD1"] + passed["FREAD2"]
    return out

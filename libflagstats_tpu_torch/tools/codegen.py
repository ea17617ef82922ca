"""Constant derivation and verification.

The port of tools/codegen.py (numpy only; the reference's offline
codegen scripts, paper/scripts/*.py, print the pshufb/vpermw lookup
tables pasted into the SIMD kernels). The bit-sliced kernels have no
lookup tables: their constants are the masked-swap transpose stages and
the plane-space transform. This tool derives those from the port's own
``flags``, ``ops/bitslice`` and ``oracle`` and checks them by brute
force, printing them in copy-pastable form, line for line as the JAX
tool does.

It also checks the port's one extra kernel constant: K6's shared-memory
table (``ops/words_kernels.word_table``), which is to the word-space
kernel what the stages are to the bit-sliced one. Entry i must be the
transformed word of i in the low 16-bit field for a QC-pass word and in
the high field for a QC-fail word, by the same truth table.

Run it after touching ops/bitslice.py or K6's table (host only, no card):
  python -m libflagstats_tpu_torch.tools.codegen
Exits 1 with the failed check on standard error.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import flags as F
from ..ops import bitslice as B
from ..oracle import transform_words

#: the words whose transforms are printed (the JAX tool's)
SHOWN_WORDS = (0x0, 0x1, 0x3, 0x63, 0x93, 0x141, 0x841, 0xB63)
WORD_TABLE_LINE = ("# K6 word table verified (4096 entries: the transformed word in the "
                   "low field for QC-pass, the high field for QC-fail)")


def derive_transpose_stages() -> list[tuple[int, int]]:
    """Check the 4-stage elided-j=16 network by brute force: every
    (word, bit) marker must land exactly once, in the row the mapping
    predicts, and every row must be a pure single-bit plane."""
    stages = [(j, m) for j, m in B.TRANSPOSE_STAGES]
    assert [j for j, _ in stages] == [8, 4, 2, 1]
    for w in range(64):
        for b in range(16):
            words = np.zeros(64, dtype=np.uint32)
            words[w] = 1 << b
            regs = [np.array([words[2 * k] | (words[2 * k + 1] << 16)], np.uint32)
                    for k in range(32)]
            out = B.transpose32_np(regs)
            hits = [(r, c) for r in range(32) for c in range(32) if (int(out[r][0]) >> c) & 1]
            assert len(hits) == 1, (w, b, hits)
            row = hits[0][0]
            assert row in (B.first_half_row(b), B.second_half_row(b)), (w, b, row)
    return stages


def derive_transform_truth_table() -> np.ndarray:
    """The exhaustive truth table of the word transform over the 7
    control bits (PAIRED, PROPER, UNMAP, MUNMAP, SEC, QCFAIL, SUP; all
    4096 words of bits 0-11), the plane-space formulation held against
    the word-space oracle (the reference's expand_data.py truth table,
    paper/scripts/expand_data.py:3-10)."""
    all_words = np.arange(4096, dtype=np.uint16)
    word_space = transform_words(all_words)
    planes = [((all_words >> k) & 1).astype(np.uint32) for k in range(12)]
    plane_space = np.zeros(4096, dtype=np.uint32)
    for k, tp in enumerate(B.transform_planes(planes)):
        plane_space |= (tp & 1) << k
    assert (word_space == plane_space).all()
    return word_space


def check_word_table(truth: np.ndarray) -> None:
    """K6's table against the truth table: the transformed word in the
    low field of a QC-pass entry, in the high field of a QC-fail one."""
    from ..ops.words_kernels import word_table

    table = word_table().numpy().view(np.uint32)
    qc = (np.arange(4096, dtype=np.uint32) >> F.FQCFAIL_OFF) & 1
    t = truth.astype(np.uint32)
    want = np.where(qc, t << 16, t)
    bad = np.flatnonzero(table != want)
    assert bad.size == 0, f"K6 word table differs at entries {bad[:8].tolist()}"


def run() -> dict:
    """Derive and check every constant; prints the lines as it goes and
    returns {"ok", "lines"}. Raises AssertionError on a failed check."""
    lines = []

    def say(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    say("# transpose stages (j, mask) — verified vs brute force")
    for j, m in derive_transpose_stages():
        say(f"  ({j:2d}, 0x{m:08X}),")
    pruned = B.pruned_pairs()
    total = sum(len(v) for v in pruned.values())
    say(f"# pruned swap pairs: {total}/80 ({ {j: len(p) for j, p in pruned.items()} })")
    tt = derive_transform_truth_table()
    say("# word transform truth table verified (4096 words, word-space == plane-space)")
    for w in SHOWN_WORDS:
        say(f"  t(0x{w:04X}) = 0x{int(tt[w]):04X}")
    say("# stream layout")
    say(f"  C streams: {list(B.C_STREAMS)}")
    say(f"  F streams: {list(B.F_STREAMS)}")
    say(f"  needed planes: {list(B.NEEDED_PLANES)}")
    check_word_table(tt)
    say(WORD_TABLE_LINE)
    say("OK")
    return {"ok": True, "lines": lines}


def main(argv=None) -> int:
    argparse.ArgumentParser(prog="codegen", description=__doc__.split("\n")[0]).parse_args(argv)
    try:
        run()
    except AssertionError as e:
        print(f"codegen: error: check failed: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The plain reference against hand-worked words, and its control."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from cardbench import spec

reference = spec.module("references", "flagstat")


def counters_of(words):
    return reference.exact(np.array(words, dtype=np.uint16), "cpu")


def expect(pass_bits=(), fail_bits=(), n_pass=1):
    c = np.zeros(32, dtype=np.int64)
    for k in pass_bits:
        c[k] += 1
    for k in fail_bits:
        c[16 + k] += 1
    c[9] = n_pass
    return c


# (word, counters set) worked by hand from samtools' flagstat rules
HAND = [
    (0x0000, expect()),                                   # unpaired, mapped
    (0x0001, expect((0, 14))),                            # paired, both mapped
    (0x0043, expect((0, 1, 6, 12, 14))),                  # proper pair, read1
    (0x0009, expect((0, 3, 13))),                         # mate unmapped: singleton
    (0x000D, expect((0, 2, 3))),                          # both unmapped
    (0x0031, expect((0, 4, 5, 14))),                      # strands count in the pair branch
    (0x0030, expect()),                                   # ... and nowhere else
    (0x0801, expect((11,))),                              # supplementary: no pair branch
    (0x0901, expect((8,))),                               # secondary beats supplementary
    (0x0404, expect((2, 10))),                            # unmapped duplicate
    (0x0281, expect(fail_bits=(0, 7, 9, 14), n_pass=0)),  # QC-fail read2
    (0xF001, expect((0, 14))),                            # bits 12-15 ignored
]


@pytest.mark.parametrize("word,want", HAND, ids=[hex(w) for w, _ in HAND])
def test_hand_worked_word(word, want):
    assert np.array_equal(counters_of([word]), want)


def test_counters_add_over_words_and_blocks(monkeypatch):
    words = [w for w, _ in HAND] * 3
    want = 3 * sum(c for _, c in HAND)
    monkeypatch.setattr(reference, "BLOCK_WORDS", 5)
    assert np.array_equal(counters_of(words), want)
    t = torch.from_numpy(np.array(words, dtype=np.uint16).view(np.int16))
    assert np.array_equal(reference.exact(t, "cpu"), want)


def test_control_loses_counts_past_float32():
    n = (1 << 24) + 1
    col = torch.full((n,), 0x0001, dtype=torch.int16)
    exact = reference.exact(col, "cpu")
    assert exact[0] == n and exact[9] == n
    control = reference.control(col, "cpu")
    assert int(np.max(np.abs(control - exact))) >= 1


def test_control_is_exact_on_small_columns():
    words = np.array([w for w, _ in HAND] * 10, dtype=np.uint16)
    assert np.array_equal(reference.control(words, "cpu"), counters_of(words))


@pytest.mark.parametrize("path", sorted((Path(spec.HERE) / "references").glob("*.py"))
                         + sorted((Path(spec.HERE) / "columns").glob("*.py"))
                         + sorted((Path(spec.HERE) / "codecs").glob("*.py")),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_references_kinds_and_codecs_import_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert names <= {"__future__", "ctypes", "numpy", "torch"}

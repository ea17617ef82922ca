"""The frozen NA12878 decomposition and the column made from it."""
import numpy as np
import pytest
import torch

from cardbench import spec

column = spec.module("columns", "na12878")
reference = spec.module("references", "flagstat")

SPEC = {"kind": "na12878", "words": 824_541_892}


def report_of(counters):
    """The published report's lines from the 32 counters (QC-fail is
    empty in NA12878)."""
    c = counters
    return {"total": c[9] + c[25], "secondary": c[8], "supplementary": c[11],
            "duplicates": c[10], "mapped": c[9] - c[2], "paired_in_sequencing": c[0],
            "read1": c[6], "read2": c[7], "properly_paired": c[12],
            "both_mapped": c[14], "singletons": c[13]}


def test_decomposition_reproduces_the_published_report():
    hist = np.zeros(1 << 16, dtype=np.int64)
    for flag, count in column.na12878_categories(1):
        hist[flag] += count
    got = report_of(hist @ reference.value_table())
    assert got == column.NA12878_PUBLISHED
    assert sum(c for _, c in column.na12878_categories(1)) == SPEC["words"]


@pytest.mark.parametrize("divisor", [1024, 4096])
def test_small_column_reproduces_the_scaled_report(divisor):
    col = column.make(SPEC, 2**31 + 7, "cpu", divisor)
    got = report_of(reference.exact(col, "cpu"))
    cats = column.na12878_categories(divisor)
    hist = np.zeros(1 << 16, dtype=np.int64)
    for flag, count in cats:
        hist[flag] += count
    assert got == report_of(hist @ reference.value_table())
    assert col.shape[0] == sum(c for _, c in cats)


def test_same_seed_same_column_other_seed_same_work():
    a = column.make(SPEC, 5_000_000_001, "cpu", 4096)
    b = column.make(SPEC, 5_000_000_001, "cpu", 4096)
    c = column.make(SPEC, 5_000_000_002, "cpu", 4096)
    assert torch.equal(a, b) and not torch.equal(a, c)
    strip = ~(3 << column.REVERSE_OFF)
    assert torch.equal(torch.sort(a & strip).values, torch.sort(c & strip).values)


def test_unknown_kind_and_wrong_size_raise():
    with pytest.raises(KeyError):
        spec.module("columns", "uniform")
    with pytest.raises(ValueError):
        column.make(dict(SPEC, words=5), 1, "cpu", 1)

"""The probe kernels' compile-time tables (ops/csrc/flagstat_probe_kernels.cu)
equal the Python tables they restate: the transpose probe's pruned
swap pairs per stage and its fold rows. Reads the source; needs no
compiler."""
import re
from pathlib import Path

import pytest

from libflagstats_tpu_torch.ops import bitslice as B

SOURCE = (Path(__file__).resolve().parent.parent / "libflagstats_tpu_torch" / "ops" / "csrc"
          / "flagstat_probe_kernels.cu").read_text()


def _mask(rows) -> int:
    return sum(1 << r for r in rows)


@pytest.mark.parametrize("stage", range(4))
def test_pruned_masks_equal_pruned_pairs(stage):
    body = re.search(r"constexpr uint32_t pruned_mask\(int s\) \{\s*return (.*?);\s*\}",
                     SOURCE, re.S).group(1)
    masks = [int(m, 16) for m in re.findall(r"0x([0-9A-Fa-f]+)u", body)]
    j, _ = B.TRANSPOSE_STAGES[stage]
    assert masks[stage] == _mask(B.pruned_pairs()[j])


def test_fold_rows_equal_needed_rows():
    value = re.search(r"constexpr uint32_t kNeededRows = 0x([0-9A-Fa-f]+)u;", SOURCE).group(1)
    assert int(value, 16) == _mask(B.NEEDED_ROWS)


def test_transpose_stage_masks_equal_the_network():
    masks = re.search(r"void transpose_pruned.*?const uint32_t m = (.*?);", SOURCE, re.S).group(1)
    assert [int(m, 16) for m in re.findall(r"0x([0-9A-Fa-f]+)u", masks)] == [
        mask for _, mask in B.TRANSPOSE_STAGES]

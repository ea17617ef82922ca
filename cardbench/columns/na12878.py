"""The column kind ``na12878``: the NA12878 FLAG column, made on a device
from a seed.

A frozen copy of the program's category decomposition: the published
samtools flagstat report of NA12878D_HiSeqX_R12 (upstream README.md,
lines 177-196) split into nine FLAG categories whose counts reproduce
every line of it. The column holds each category's words, REVERSE and
MREVERSE set at random (they enter no report line), in a random order.
Every seed gives the same category counts, so the same work, in another
order and with other strand bits.

A column kind module gives ``make(spec, seed, device, scale_divisor)``:
the configuration's data, made on ``device`` from ``seed``.
"""
from __future__ import annotations

import torch

PAIRED, PROPER, UNMAP, MUNMAP = 1 << 0, 1 << 1, 1 << 2, 1 << 3
REVERSE_OFF = 4
READ1, READ2 = 1 << 6, 1 << 7
SUPPLEMENTARY = 1 << 11

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


def na12878_categories(scale_divisor: int = 1) -> list[tuple[int, int]]:
    """(flag, count) pairs whose report is the published one (each count
    divided by ``scale_divisor``, for tests).

    unpaired = total - paired = supplementary (all mapped); properly
    paired and not-proper pairs split evenly between READ1 and READ2;
    singletons and self-unmapped pairs balance read1 = read2."""
    p = NA12878_PUBLISHED
    if p["total"] - p["paired_in_sequencing"] != p["supplementary"]:
        raise ValueError("published report: unpaired != supplementary")
    if p["mapped"] - p["both_mapped"] - p["singletons"] != p["supplementary"]:
        raise ValueError("published report: mapped does not decompose")
    proper = p["properly_paired"]
    notproper = p["both_mapped"] - proper
    sgl = p["singletons"]
    self_unmap = p["paired_in_sequencing"] - p["both_mapped"] - sgl
    r1_rest = p["read1"] - proper // 2 - notproper // 2
    sgl_r1 = sgl // 2
    unm_r1 = r1_rest - sgl_r1
    cats = [
        (SUPPLEMENTARY, p["supplementary"]),
        (PAIRED | PROPER | READ1, proper // 2),
        (PAIRED | PROPER | READ2, proper - proper // 2),
        (PAIRED | READ1, notproper // 2),
        (PAIRED | READ2, notproper - notproper // 2),
        (PAIRED | MUNMAP | READ1, sgl_r1),
        (PAIRED | MUNMAP | READ2, sgl - sgl_r1),
        (PAIRED | UNMAP | MUNMAP | READ1, unm_r1),
        (PAIRED | UNMAP | MUNMAP | READ2, self_unmap - unm_r1),
    ]
    return [(f, c // scale_divisor) for f, c in cats]


def make(spec: dict, seed: int, device, scale_divisor: int = 1) -> torch.Tensor:
    """The column of ``spec`` (a configuration's ``column``) as an int16
    tensor (the uint16 words' bits) on ``device``, drawn from ``seed`` by
    a generator on that device, in a few large calls."""
    device = torch.device(device)
    cats = na12878_categories(scale_divisor)
    flags = torch.tensor([f for f, _ in cats], dtype=torch.int16, device=device)
    counts = torch.tensor([c for _, c in cats], dtype=torch.int64, device=device)
    n = sum(c for _, c in cats)
    if scale_divisor == 1 and n != spec["words"]:
        raise ValueError(f"the categories hold {n} words, the configuration {spec['words']}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    col = torch.repeat_interleave(flags, counts, output_size=n)
    col = col[torch.randperm(n, generator=gen, device=device)]
    col |= torch.randint(0, 4, (n,), generator=gen, device=device,
                         dtype=torch.int16) << REVERSE_OFF
    return col

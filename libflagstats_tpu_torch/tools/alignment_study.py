"""Host buffer-alignment experiment for the native kernels.

The port of tools/alignment_study.py. The reference treats 64-byte
aligned against unaligned allocations as a measured question, shipping a
dedicated -DALIGN build variant (reference: Makefile:66-67,
linux/instrumented_benchmark.cpp:23-28). The native tier uses unaligned
loads (loadu) throughout, so the expectation is about no effect on a
modern x86 host, and this measures it: the same kernels
(``lfs_flagstat_u16``, ``lfs_pospopcnt_u16`` of the port's host library)
over the same data placed at a 64-byte aligned base and at bases offset
by +2, +6 and +62 bytes, the minimum over ``iters`` runs, fresh data
every run. Host only: it takes no device.

Run: python -m libflagstats_tpu_torch.tools.alignment_study [--n 16777216] [--iters 9]
Exits 1 with one line when the native host library did not build.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io import native_lib
from ..ops import native_host
from ..oracle import generate_flags

OFFSETS = (0, 2, 6, 62)
HEADER = "kernel\toffset_B\tmin_ms\tGwords/s\tvs_aligned"


def _place(words: np.ndarray, offset_bytes: int) -> np.ndarray:
    """A uint16 view of ``words`` whose data pointer sits at a 64-byte
    boundary plus ``offset_bytes`` (even: uint16 views need 2-byte
    alignment)."""
    assert offset_bytes % 2 == 0
    raw = np.zeros(2 * words.size + 128, dtype=np.uint8)
    skew = (-raw.ctypes.data) % 64 + offset_bytes
    view = raw[skew:skew + 2 * words.size].view(np.uint16)
    assert view.ctypes.data % 64 == offset_bytes % 64
    view[:] = words
    return view


def run(n_words: int = 1 << 24, iters: int = 9, threads: int = 1) -> list[dict]:
    """One row {"kernel", "offset_bytes", "min_s", "gwords_per_s"} per
    kernel and offset; the first of ``iters + 1`` runs is a warm-up."""
    if not native_host.available():
        raise RuntimeError(f"the native host library did not build: {native_lib.BUILD_ERROR}")
    kernels = {
        "lfs_flagstat_u16": lambda a: native_host.flagstat_native(a, threads=threads),
        "lfs_pospopcnt_u16": lambda a: native_host.pospopcnt_native(a, threads=threads),
    }
    rows = []
    for name, fn in kernels.items():
        for off in OFFSETS:
            best = float("inf")
            for it in range(iters + 1):
                x = _place(generate_flags(n_words, seed=it, full_range=True), off)
                t0 = time.perf_counter()
                fn(x)
                dt = time.perf_counter() - t0
                if it:
                    best = min(best, dt)
            rows.append({"kernel": name, "offset_bytes": off, "min_s": best,
                         "gwords_per_s": n_words / best / 1e9})
    return rows


def format_rows(rows: list[dict]) -> list[str]:
    """The table: one line per row, its time against the aligned base's."""
    lines = [HEADER]
    base = {}
    for r in rows:
        if r["offset_bytes"] == 0:
            base[r["kernel"]] = r["min_s"]
        rel = base[r["kernel"]] / r["min_s"]
        lines.append(f"{r['kernel']}\t{r['offset_bytes']}\t{r['min_s'] * 1e3:.3f}\t"
                     f"{r['gwords_per_s']:.3f}\t{rel:.3f}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="alignment_study")
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--iters", type=int, default=9)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)
    try:
        rows = run(args.n, args.iters, args.threads)
    except RuntimeError as e:
        print(f"alignment_study: error: {e}", file=sys.stderr)
        return 1
    print("\n".join(format_rows(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

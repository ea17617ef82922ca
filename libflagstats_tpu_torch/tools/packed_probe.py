"""Packed-plane-layout probe on the card: what do unread plane rows cost?

The port of tools/packed_probe.py. The plane-tile flagstat kernel (K2)
reads only the 24 ``bitslice.NEEDED_ROWS`` of each 32-row tile (the
planes of FLAG bits 12-15 are dead to the transform). Three runs of the
fold kernel (K8, ``ops/probe_kernels.fold_xor_cuda``) over seeded tiles
say whether shipping 24-row tiles buys the 25% of traffic it implies, or
whether a kernel that skips rows gets the same from 32-row tiles:

  full32   xor-fold all 32 rows of (G, 32, 8, 128)
  sub24    xor-fold only NEEDED_ROWS of the same tiles
           (are the rows a kernel skips really not fetched?)
  pack24   xor-fold all of (G, 24, 8, 128)

Each case is first held against the numpy fold, then timed with the
gated multi-K fit (bench/harness.py) and priced at the bytes of the rows
it folds against the defended read roofline. pack24/full32 = 0.75 would
be the whole traffic cut; sub24/full32 < 1 means skipped rows are not
fetched, and sub24 = pack24 that packing on the host buys the kernel
nothing (it still saves the bus and the memory).

Run on the card: python -m libflagstats_tpu_torch.tools.packed_probe
(``--device cpu --groups 8`` shows the table's form on the CPU.)
Exits 1 with one line when there is no card, and 1 on any MISMATCH.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import bitslice as B
from ..ops import probe_kernels as P
from ..ops.kernels import LANE, SUB

GROUPS = 1024            # 64Mi words of 65,536-word groups
KS = (4, 64, 260)        # repetition counts of the fits
FIT_ITERS = 4
FIT_ATTEMPTS = 4
HEADER = "case\tms\tGB/s(own bytes)\tGB/s(32-row-equiv)\tvs_roofline\tdisp\tgate\tcheck"


def run(groups: int = GROUPS, device=None) -> dict:
    """The three cases over ``groups`` seeded tiles on ``device``
    (default: the current CUDA device; raises with no card unless
    device="cpu"). Prints the table and the two ratio lines; returns
    {"ok", "times" (case -> seconds), "lines"}."""
    from ..bench.harness import defended_roofline, gated_kernel_time_fit, timing_device

    dev = timing_device(device)
    rng = np.random.default_rng(7)
    host32 = rng.integers(0, 1 << 32, size=(groups, 32, SUB, LANE),
                          dtype=np.uint64).astype(np.uint32)
    needed = sorted(B.NEEDED_ROWS)
    host24 = np.ascontiguousarray(host32[:, needed])
    planes32 = torch.from_numpy(host32.view(np.int32)).to(dev)
    planes24 = torch.from_numpy(host24.view(np.int32)).to(dev)

    equiv_bytes = host32.nbytes
    roof = defended_roofline(equiv_bytes, ks=KS, device=dev)
    if roof != roof:  # NaN: no sample passed the gates
        roof = None
    cases = [("full32", planes32, None, host32),
             ("sub24", planes32, needed, host32),
             ("pack24", planes24, None, host24)]
    lines = [HEADER]
    times = {}
    ok = True
    for name, inp, rows, host in cases:
        n_bytes = groups * (len(rows) if rows else inp.shape[1]) * 4 * SUB * LANE
        good = P.digest(P.fold_xor_cuda(inp, rows)) == P.fold_xor_np(host, rows)
        ok &= good
        fit = gated_kernel_time_fit(lambda p, rows=rows: P.fold_xor_cuda(p, rows), inp,
                                    roof_bytes_per_s=roof, n_bytes=n_bytes, ks=KS,
                                    iters=FIT_ITERS, attempts=FIT_ATTEMPTS, device=dev)
        t = times[name] = fit.slope_s
        vs = f"{n_bytes / t / roof:.3f}" if roof else "n/a"
        lines.append(f"{name}\t{t * 1e3:.4f}\t{n_bytes / t / 1e9:.1f}\t"
                     f"{equiv_bytes / t / 1e9:.1f}\t{vs}\t{fit.dispersion:.3f}\t"
                     f"{fit.gate_passed}\t{'OK' if good else 'MISMATCH'}")
    lines.append(f"# pack24/full32 = {times['pack24'] / times['full32']:.3f} "
                 f"(0.75 = the whole traffic cut)")
    lines.append(f"# sub24/full32  = {times['sub24'] / times['full32']:.3f} "
                 f"(<1.0: rows the kernel skips are not fetched)")
    print("\n".join(lines))
    return {"ok": ok, "times": times, "lines": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="packed_probe")
    ap.add_argument("--groups", type=int, default=GROUPS, help="64Mi words by default")
    ap.add_argument("--device", default=None, help="'cpu' runs the plain versions on the CPU")
    args = ap.parse_args(argv)
    try:
        return 0 if run(args.groups, args.device)["ok"] else 1
    except RuntimeError as e:  # no card: one line, no fallback
        print(f"packed_probe: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

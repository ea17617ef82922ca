"""Instrumented per-variant benchmark (reference:
linux/instrumented_benchmark.cpp).

The port of ``libflagstats_tpu.bench.instrumented``:
* fresh full-range data every iteration (":174-179");
* every iteration's counters checked against the host oracle
  (":181-208");
* min and average over the iterations (":107-142"), host wall time of one
  entry-point call (a host column in, counters on the host out: the copy
  to the card included);
* the memory speed of light (":456-544"): the defended read roofline on
  the card, over at least ``ROOFLINE_MIN_BYTES`` so that it is read from
  device memory and not from the 50 MB L2, and the host memcpy over the
  column's bytes on the CPU; a note on standard error names the bytes it
  was taken over;
* tab-separated rows (`-t`, ":310-319");
* the reference's hardware counters per word (":161-166, 417-454") for
  the native host kernels, after a blank line: ``perf_native``'s block
  (``hw`` rows where the host exposes a PMU, ``sw-only`` rows where only
  software events open, else one "perf_event unavailable: <why>" line).

The variants: ``numpy``, ``native`` (where g++ builds the host library)
and ``torch`` on the timing device, and on the card ``cuda``,
``cuda_pre`` and ``cuda_words``.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np

from ..ops import native_host
from ..ops.dispatch import get_function
from ..oracle import flagstat_numpy, generate_flags
from .harness import defended_roofline, timing_device

HEADER = "variant\twords\tmin_us\tavg_us\tMwords/s\tGB/s\tvs_roofline\tcheck"
#: the least bytes the card's read roofline is measured over: 5x the
#: H100's 50 MB L2 (below ~50 MB its gates fail and the column drops)
ROOFLINE_MIN_BYTES = 256 << 20


def roofline_bytes(n: int) -> int:
    """Bytes the card's read roofline is measured over for an ``n``-word
    run: the column's bytes, or ROOFLINE_MIN_BYTES when they are fewer."""
    return max(2 * n, ROOFLINE_MIN_BYTES)


@dataclass
class VariantResult:
    name: str
    n: int
    iters: int
    min_s: float
    avg_s: float
    correct: bool

    def row(self, roof: float | None) -> str:
        gbs = 2.0 * self.n / self.min_s / 1e9
        frac = f"{2.0 * self.n / self.min_s / roof:.3f}" if roof else "n/a"
        return (f"{self.name}\t{self.n}\t{self.min_s * 1e6:.1f}\t{self.avg_s * 1e6:.1f}"
                f"\t{self.n / self.min_s / 1e6:.1f}\t{gbs:.2f}\t{frac}\t"
                f"{'ok' if self.correct else 'FAIL'}")


def run_variant(name: str, fn, n: int, iters: int, verbose: bool = False) -> VariantResult:
    """``iters`` timed calls of ``fn`` (after one untimed warm-up), each
    on fresh data and checked against the oracle."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters} (the first "
                         "iteration is warmup-only and is never timed)")
    times = []
    correct = True
    for it in range(iters + 1):
        x = generate_flags(n, seed=1000 + it, full_range=True)
        t0 = time.perf_counter()
        got = np.asarray(fn(x), dtype=np.int64)   # host counters: the call is complete
        dt = time.perf_counter() - t0
        if it > 0:
            times.append(dt)
        ref = flagstat_numpy(x).astype(np.int64)
        ok = bool((got == ref).all())
        if not ok and verbose:
            print(f"{name}: mismatch at iter {it}:\nexp {ref}\ngot {got}")
        correct &= ok
    return VariantResult(name, n, iters, min(times), sum(times) / len(times), correct)


def host_memcpy_roofline(n_words: int, iters: int = 5) -> float:
    """Host memcpy speed of light in bytes/s over the same array size
    (the reference's memcpy baseline, instrumented_benchmark.cpp:456-544)."""
    src = generate_flags(n_words, seed=0)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return 2.0 * n_words / best


def run_all(n: int = 1 << 20, iters: int = 5, with_roofline: bool = True,
            verbose: bool = False, device=None, with_perf: bool = True) -> list[str]:
    """The header, one row per variant and, with ``with_perf`` and the
    native host library, a blank line and the perf block (``rows``
    splits the variant rows off)."""
    dev = timing_device(device)
    variants = ["numpy"] + (["native"] if native_host.available() else []) + ["torch"]
    if dev.type == "cuda":
        variants += ["cuda", "cuda_pre", "cuda_words"]

    roof = None
    if with_roofline:
        if dev.type == "cuda":
            nbytes = roofline_bytes(n)
            r = defended_roofline(nbytes, device=dev)
            roof = r if r == r else None
            note = f"note: roofline: defended read on {dev}, over {nbytes} bytes"
        else:
            roof = host_memcpy_roofline(n)
            note = f"note: roofline: host memcpy, over {2 * n} bytes"
        print(note + ("" if roof else ", failed its gates"), file=sys.stderr)

    lines = [HEADER]
    for name in variants:
        fn = get_function(n, impl=name, device=None if name in ("numpy", "native") else dev)
        lines.append(run_variant(name, fn, n, iters, verbose=verbose).row(roof))
    if with_perf and native_host.available():
        from . import perf_native

        lines.append("")
        lines += perf_native.format_report(
            perf_native.native_kernel_report(n_words=n, iters=max(iters, 3))).splitlines()
    return lines


def rows(lines: list[str]) -> list[str]:
    """The variant rows of ``run_all``'s lines (no header, no perf block)."""
    return lines[1:lines.index("")] if "" in lines else lines[1:]

"""Measure where each tier starts to win, by input size, on this machine.

The port of tools/crossover_sweep.py. The reference encodes measured
crossovers in its size-tiered dispatchers (STORM_pospopcnt_u16,
libalgebra.h:3519-3543; FLAGSTATS_u16, libflagstats.h:2999-3021). This
sweep takes the same measurements for the port, per size:

  * host: ``flagstat_numpy`` and the native AVX2 count, wall time;
  * device wall: one synchronised call on a host column, its copy to
    the device included (what a single ``flagstats_u16`` call pays), for
    the plain torch tier and for the bit-sliced kernel (K1);
  * device kernel: launch-free time per call from the gated multi-K fit
    (what a streaming caller pays per chunk).

It prints a TSV and the sizes from which each tier wins. K1 runs at
every size: the kernel masks its own edges. ``--pospopcnt`` sweeps the
positional-popcount tiers instead (host per-bit count, native, torch,
K5).

``--write``, with ``--device cpu``, records the one crossover the
port's dispatch reads: ``TORCH_MIN_CPU`` (``POSPOPCNT_TORCH_MIN_CPU``
with ``--pospopcnt``), the smallest swept size from which the torch
tier's single-call wall beats numpy's at every larger swept size, or
the disabled sentinel 2^62 when torch does not win at the largest. It
goes into the port's calibration file (calibration.py) with its
provenance: date, backend, the card as ``nvidia-smi`` names it, the
median wall-minus-kernel gap and the tool. A call on the card reads no
threshold, so ``--write`` without ``--device cpu`` is refused.

Run on the card:
  python -m libflagstats_tpu_torch.tools.crossover_sweep [--pospopcnt] [sizes ...]
  python -m libflagstats_tpu_torch.tools.crossover_sweep --device cpu --write [--pospopcnt]
Exits 1 with one line when there is no card and no ``--device cpu``.
"""
from __future__ import annotations

import argparse
import datetime
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import kernels as K
from ..ops import native_host
from ..ops.dispatch import pospopcnt_u16
from ..ops.torch_ops import as_words, pospopcnt_u16_torch, stream_sums_torch
from ..oracle import flagstat_numpy, generate_flags

SIZES = tuple(1 << k for k in range(10, 27, 2))   # 1Ki..64Mi words, 4x steps
HEADER = ("words\tnumpy_ms\tnative_ms\ttorch_wall_ms\ttorch_kern_ms\t"
          "cuda_wall_ms\tcuda_kern_ms")
FIT_ITERS = 3
FIT_ATTEMPTS = 3
WALL_ITERS = 5


def _ks(n: int) -> tuple:
    return (2, 8, 24) if n >= (1 << 22) else (4, 32, 96)


def _host_min(fn, x, runs: int) -> float:
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(x)
        best = min(best, time.perf_counter() - t0)
    return best


def _first_size(rows, pred):
    return next((r[0] for r in rows if pred(r)), None)


def run(sizes=SIZES, pospopcnt: bool = False, device=None) -> dict:
    """The sweep over ``sizes`` on ``device`` (default: the current CUDA
    device; raises with no card unless device="cpu", which leaves the
    kernel's columns nan). Prints the TSV and the suggestions; returns
    {"rows", "suggested", "lines"}; a row is (words, numpy_s, native_s,
    torch_wall_s, torch_kern_s, cuda_wall_s, cuda_kern_s)."""
    from ..bench.harness import gated_kernel_time_fit, timing_device, wall_time_min

    dev = timing_device(device)
    if pospopcnt:
        host_fn = lambda a: pospopcnt_u16(a, impl="numpy")      # noqa: E731
        native_fn = native_host.pospopcnt_native
        torch_body = pospopcnt_u16_torch
        cuda_body = lambda a: K.stream_sums_cuda(a, "pospopcnt")  # noqa: E731
    else:
        host_fn, native_fn = flagstat_numpy, native_host.flagstat_native
        torch_body = lambda a: torch.cat(stream_sums_torch(a))    # noqa: E731
        cuda_body = lambda a: K.stream_sums_cuda(a, "flagstat")   # noqa: E731
    lines = []

    def say(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    say(f"# device={torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}"
        f"{' mode=pospopcnt' if pospopcnt else ''}")
    say(HEADER)
    rows = []
    for n in sizes:
        x = generate_flags(n, seed=n & 0xFFFF, full_range=True)
        t_numpy = _host_min(host_fn, x, 2)
        t_native = _host_min(native_fn, x, 3) if native_host.available() else float("nan")

        x_host = as_words(x)
        x_dev = x_host.to(dev)

        def measure(body):
            wall = wall_time_min(lambda h: body(h.to(dev)), x_host, iters=WALL_ITERS,
                                 warmup=2, device=dev)
            kern = gated_kernel_time_fit(body, x_dev, ks=_ks(n), iters=FIT_ITERS,
                                         attempts=FIT_ATTEMPTS, device=dev).slope_s
            return wall, kern

        t_t_wall, t_t_kern = measure(torch_body)
        t_c_wall = t_c_kern = float("nan")
        if dev.type == "cuda":
            t_c_wall, t_c_kern = measure(cuda_body)
        rows.append((n, t_numpy, t_native, t_t_wall, t_t_kern, t_c_wall, t_c_kern))
        say(f"{n}\t{t_numpy * 1e3:.3f}\t{t_native * 1e3:.3f}\t{t_t_wall * 1e3:.3f}\t"
            f"{t_t_kern * 1e3:.4f}\t{t_c_wall * 1e3:.3f}\t{t_c_kern * 1e3:.4f}")

    def dev_wall(r):  # the better device wall (nan-safe: a nan never wins)
        return min(v for v in (r[3], r[5], float("inf")) if v == v)

    suggested = {
        "TORCH_MIN (single-call wall beats numpy)": _first_size(rows, lambda r: r[3] < r[1]),
        "CUDA_MIN (single-call wall beats numpy and torch)":
            _first_size(rows, lambda r: r[5] == r[5] and r[5] < min(r[1], r[3])),
        "CUDA_MIN (launch-free kernel beats torch's)":
            _first_size(rows, lambda r: r[6] == r[6] and r[6] < r[4]),
        "NATIVE_DEVICE_MIN (device wall beats native host)":
            _first_size(rows, lambda r: r[2] == r[2] and dev_wall(r) < r[2]),
    }
    for name, size in suggested.items():
        say(f"# suggested {'pospopcnt ' if pospopcnt else ''}{name}: {size}")
    # the order need not hold from the first crossover on
    say("# sizes where the native host count beats the device wall: "
        f"{[r[0] for r in rows if r[2] == r[2] and r[2] <= dev_wall(r)]}")
    return {"rows": rows, "suggested": suggested, "lines": lines}


#: the threshold value that disables a tier: torch never won in the range
DISABLED = 1 << 62


def torch_min(rows) -> int | None:
    """The smallest swept size from which the torch wall (column 3)
    beats numpy's (column 1) at every larger swept size; None when it
    does not win at the largest."""
    found = None
    for r in reversed(sorted(rows)):
        if not r[3] < r[1]:
            break
        found = r[0]
    return found


def card() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it (first line), or "none"."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "none"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else "none"


def _rtt_ms(rows, wall_col: int, kern_col: int) -> float:
    """Median wall-minus-kernel gap over the measured rows: the per-call
    cost the single-call crossover prices in."""
    gaps = sorted((r[wall_col] - r[kern_col]) * 1e3 for r in rows
                  if r[wall_col] == r[wall_col] and r[kern_col] == r[kern_col])
    return gaps[len(gaps) // 2] if gaps else float("nan")


def _provenance(backend: str, rtt_ms: float | None) -> dict:
    prov = {"date": datetime.date.today().isoformat(), "backend": backend,
            "card": card(), "tool": "crossover_sweep"}
    if rtt_ms is not None and rtt_ms == rtt_ms:
        prov["dispatch_rtt_ms"] = round(rtt_ms, 3)
    return prov


def _write_calibration(thresholds: dict, backend: str, rtt_ms: float | None) -> None:
    """Write the thresholds that are not None, with their provenance; a
    dict of Nones leaves the file untouched."""
    from ..calibration import write_thresholds

    thresholds = {k: v for k, v in thresholds.items() if v is not None}
    if not thresholds:
        print("# --write: no crossover measured in this size range; calibration file "
              "left untouched")
        return
    path = write_thresholds(thresholds, _provenance(backend, rtt_ms))
    print(f"# wrote {sorted(thresholds)} to {path} (ops/dispatch.py applies it at import)")


def write(rows, pospopcnt: bool) -> None:
    """``--write``: the measured numpy -> torch crossover of a CPU sweep,
    or the disabled sentinel when torch never wins in the range."""
    found = torch_min(rows)
    name = "POSPOPCNT_TORCH_MIN_CPU" if pospopcnt else "TORCH_MIN_CPU"
    _write_calibration({name: DISABLED if found is None else found}, "cpu",
                       _rtt_ms(rows, 3, 4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crossover_sweep")
    ap.add_argument("sizes", type=int, nargs="*", default=SIZES,
                    help="word counts; 1Ki..64Mi in 4x steps by default")
    ap.add_argument("--pospopcnt", action="store_true")
    ap.add_argument("--device", default=None, help="'cpu' times the torch tier on the CPU")
    ap.add_argument("--write", action="store_true",
                    help="with --device cpu: record the numpy -> torch crossover in the "
                         "port's calibration file")
    args = ap.parse_args(argv)
    if args.write and args.device != "cpu":
        ap.error("--write records the tier of calls that ask for the CPU: add --device cpu")
    try:
        res = run(args.sizes, args.pospopcnt, args.device)
    except RuntimeError as e:  # no card: one line, no fallback
        print(f"crossover_sweep: error: {e}", file=sys.stderr)
        return 1
    if args.write:
        write(res["rows"], args.pospopcnt)
    return 0


if __name__ == "__main__":
    sys.exit(main())

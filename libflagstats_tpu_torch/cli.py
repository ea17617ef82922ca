"""Command-line entry points of the port: the measurement subcommands.

The counterpart of ``libflagstats_tpu.cli``'s
  inmemory      correctness + speed harness       (benchmark/inmemory.cpp)
  instrumented  per-variant table, fresh data and
                an oracle check every iteration   (linux/instrumented_benchmark.cpp)
  kernels       per-kernel throughput table
                against the read roofline

They run on the card; ``--device cpu`` asks for the CPU. With no card
and no ``--device``, they exit with one error line. The other
subcommands of the JAX package wait for the port of the container
readers.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import flags as F
from .ops import native_host
from .ops.dispatch import get_function
from .oracle import flagstat_numpy, generate_flags

PROG = "libflagstats_tpu_torch"


def _cmd_inmemory(args):
    """Run every implementation once (after a warm-up), diff against the
    host oracle over the tested counters, print timing (reference:
    benchmark/inmemory.cpp)."""
    from .bench.harness import timing_device

    dev = timing_device(args.device)
    n = args.n
    x = generate_flags(n, seed=0)  # seeded, [0, 4096) like inmemory.cpp:108-116
    ref = flagstat_numpy(x).astype(np.int64)
    impls = ["numpy"] + (["native"] if native_host.available() else []) + ["torch"]
    if dev.type == "cuda":
        impls += ["cuda", "cuda_pre", "cuda_words"]
    tested = list(F.TESTED_COUNTERS)
    rows = []
    for impl in impls:
        fn = get_function(n, impl=impl, device=None if impl in ("numpy", "native") else dev)
        fn(x)  # warm-up (first launch, kernel build)
        t0 = time.perf_counter()
        got = np.asarray(fn(x), dtype=np.int64)
        dt = time.perf_counter() - t0
        rows.append((impl, dt, bool((got[tested] == ref[tested]).all())))
    w = max(len(r[0]) for r in rows)
    for impl, dt, ok in rows:
        print(f"{impl:<{w}}  {dt * 1e6:10.1f} us  {n / dt / 1e6:10.1f} Mwords/s  "
              f"{'OK' if ok else 'MISMATCH'}")
    print(f"note: host wall of one call on {dev}, copies included; "
          "`kernels` measures device kernel time", file=sys.stderr)
    return 0 if all(r[2] for r in rows) else 1


def _cmd_instrumented(args):
    from .bench.instrumented import run_all

    lines = run_all(n=args.n, iters=args.iters, with_roofline=not args.no_roofline,
                    verbose=args.verbose, device=args.device)
    for line in lines:
        print(line)
    return 0 if all(line.endswith("\tok") for line in lines[1:]) else 1


def _cmd_kernels(args):
    from .bench.kernels import run

    lines = run(n_words=args.n, iters=args.iters, device=args.device)
    for line in lines:
        print(line)
    return 1 if any("MISMATCH" in line for line in lines) else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog=PROG)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(parser):
        parser.add_argument("--device", default=None,
                            help="where to count and time (default: the current "
                                 "CUDA device; 'cpu' asks for the CPU)")

    m = sub.add_parser("inmemory", help="correctness+speed harness")
    m.add_argument("-n", type=int, default=1024 * 100)
    device_arg(m)
    m.set_defaults(fn=_cmd_inmemory)

    b = sub.add_parser(
        "instrumented",
        help="per-variant benchmark: fresh data + oracle check per iter, "
             "min/avg, roofline fraction (linux/instrumented_benchmark.cpp)")
    b.add_argument("-n", type=int, default=1 << 20)
    b.add_argument("-i", "--iters", type=int, default=5)
    b.add_argument("-v", "--verbose", action="store_true")
    b.add_argument("--no-roofline", action="store_true")
    device_arg(b)
    b.set_defaults(fn=_cmd_instrumented)

    k = sub.add_parser("kernels", help="per-kernel throughput table vs the read roofline")
    k.add_argument("-n", type=int, default=64 * 1024 * 1024)
    k.add_argument("-i", "--iters", type=int, default=5)
    device_arg(k)
    k.set_defaults(fn=_cmd_kernels)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, OSError, RuntimeError) as e:
        # a bad argument or no card: one clean line, nonzero rc (the
        # reference's run_screaming pattern, flagstats.cpp:105-108)
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

"""Command-line entry points of the port (reference parity: benchmark/
and linux/ tools), the counterpart of ``libflagstats_tpu.cli``:

  generate      synthetic FLAG vectors            (benchmark/generate.cpp)
  utility       text FLAGs -> uint16 binary       (benchmark/utility.cpp)
  compress      column (binary/.bam/.sam[.gz]) ->
                framed LZ4/Zstd stream            (bench compress, flagstats.cpp:738)
  decompress    framed/raw stream modes -r/-d/-s,
                -R/-D/-S                          (bench decompress, flagstats.cpp:841)
  flagstat      samtools-style report of any
                container                         (flagstats.cpp:578-590)
  bam2flags     BAM/SAM -> uint16 FLAG column     (samtools view | cut -f2 | utility)
  codec-sweep   compression/decode/flagstat table
                over codec levels                 (reference README.md:136-175)
  inmemory      correctness + speed harness       (benchmark/inmemory.cpp)
  instrumented  per-variant table, fresh data and
                an oracle check every iteration   (linux/instrumented_benchmark.cpp)
  kernels       per-kernel throughput table
                against the read roofline

The subcommands that count (flagstat, decompress, codec-sweep and the
three measurement ones) count on the card; ``--device cpu`` asks for the
CPU, and ``--impl native`` / ``numpy`` for a host tier. With no card and
neither, they exit with one error line, as every bad input does.
"""
from __future__ import annotations

import argparse
import sys
import time
import zlib

import numpy as np

from . import flags as F
from .io import codec as C
from .io import samio
from .ops import native_host
from .ops.dispatch import FLAGSTAT_IMPLS, flagstats_u16, get_function
from .oracle import flagstat_loop, flagstat_numpy, generate_flags
from .report import counters_to_report

PROG = "libflagstats_tpu_torch"


def _cmd_generate(args):
    if args.binary:
        samio.generate_binary(args.n, args.binary, seed=args.seed,
                              full_range=args.full_range)
    else:
        samio.generate_text(args.n, sys.stdout, seed=args.seed,
                            full_range=args.full_range)
    return 0


def _cmd_utility(args):
    import contextlib

    with contextlib.ExitStack() as stack:
        src = (stack.enter_context(open(args.input, "r"))
               if args.input else sys.stdin)
        dst = (stack.enter_context(open(args.output, "wb"))
               if args.output else sys.stdout.buffer)
        n = samio.text_to_binary(src, dst)
    print(f"wrote {n} words", file=sys.stderr)
    return 0


def _cmd_compress(args):
    # any container in (.bam/.sam[.gz]/binary), framed stream out — so
    # `compress x.bam` builds the reference's benchmark format directly
    from .io import read_flags_auto

    flags_arr = read_flags_auto(args.input, threads=args.threads)
    out = args.output or C.codec_filename(args.input, args.codec, args.level)
    t0 = time.perf_counter()
    info = C.write_framed(out, flags_arr, codec=args.codec, level=args.level,
                          block_bytes=args.block_bytes)
    dt = time.perf_counter() - t0
    ratio = info.raw_bytes / max(info.compressed_bytes, 1)
    print(f"{out}: {info.n_blocks} blocks, {info.raw_bytes} -> "
          f"{info.compressed_bytes} bytes ({ratio:.2f}x) in {dt*1e3:.1f} ms",
          file=sys.stderr)
    return 0


def _flagstat_array(arr: np.ndarray, impl: str | None, device):
    counters = np.zeros(F.N_COUNTERS, dtype=np.uint64)
    flagstats_u16(arr, out=counters, impl=impl, device=device)
    return counters


def _drop_caches() -> bool:
    """Drop the OS page cache for cold-IO measurement (reference:
    clear_cache(), benchmark/flagstats.cpp:82-88; needs root)."""
    import os

    try:
        os.sync()
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except OSError:
        return False


def _cmd_decompress(args):
    mode = args.mode
    if args.drop_caches and not _drop_caches():
        print("warning: could not drop page caches (need root)",
              file=sys.stderr)
    if args.stream and mode == "d":
        # overlapped decode+count pipeline (io/stream.py)
        from .bench.profiling import SectionTimer
        from .io.stream import flagstat_stream

        timer = SectionTimer() if args.timers else None
        t0 = time.perf_counter()
        counters = flagstat_stream(args.input, codec=args.codec,
                                   impl=args.impl, threads=args.threads,
                                   timer=timer, device=args.device)
        dt = time.perf_counter() - t0
        n = int(counters[9] + counters[25])
        print(f"[d/stream] {n} words: total {dt*1e3:.1f} ms "
              f"({n/dt/1e6:.1f} Mwords/s)", file=sys.stderr)
        if timer is not None:
            print("[d/stream] pipeline wall-time breakdown:", file=sys.stderr)
            print(timer.report(), file=sys.stderr)
        print(counters_to_report(counters).text())
        return 0

    t0 = time.perf_counter()
    if mode in ("R", "D", "S"):  # raw binary file modes
        arr = samio.read_binary(args.input)
    else:                          # framed compressed stream modes
        arr = C.read_framed(args.input, args.codec, n_threads=args.threads)
    t_load = time.perf_counter() - t0

    counters = None
    if mode in ("d", "D"):
        counters = _flagstat_array(arr, args.impl, args.device)
    elif mode in ("s", "S"):
        # the branchy per-record loop (reference -s/-S modes,
        # flagstats.cpp:51-70): the vectorized host oracle, or with
        # --loop the literal per-word loop; count_paired fills counter 0,
        # which the report's paired lines read
        counters = (flagstat_loop(arr, count_paired=True) if args.loop
                    else flagstat_numpy(arr))
    dt = time.perf_counter() - t0
    print(f"[{mode}] {arr.size} words: load {t_load*1e3:.1f} ms, "
          f"total {dt*1e3:.1f} ms "
          f"({arr.size/dt/1e6:.1f} Mwords/s)", file=sys.stderr)
    if counters is not None:
        print(counters_to_report(counters).text())
    return 0


def _cmd_flagstat(args):
    # the full `samtools flagstat <file>` workload, samtools-free, on
    # any supported container (flagstat_file routes by sniffed kind)
    from . import flagstat_file

    counters = flagstat_file(args.input, threads=args.threads,
                             impl=args.impl, device=args.device)
    print(counters_to_report(counters).text())
    return 0


def _cmd_bam2flags(args):
    """BAM/SAM -> binary uint16 FLAG column (the reference gets this via
    `samtools view | cut -f2 | utility`, reference README.md:56)."""
    from .io import read_flags_auto

    flags_arr = read_flags_auto(args.input, threads=args.threads)
    out = args.output or (str(args.input) + ".flags.bin")
    flags_arr.tofile(out)
    print(f"{out}: {flags_arr.size} FLAG words", file=sys.stderr)
    return 0


def _cmd_codec_sweep(args):
    """Per-codec/level compression + decode + flagstat timing table
    (reference: the README.md:136-175 sweep of LZ4-HC c1-9, LZ4-fast,
    Zstd c1-20 over the NA12878 column). Times are host walls."""
    import tempfile
    from pathlib import Path

    arr = samio.read_binary(args.input)
    configs = (
        [("lz4", lv,
          f"HC_c{lv}" if lv > 1 else f"fast_a{1 - C._lz4_effort(lv)}")
         for lv in args.lz4_levels]
        # LZ4-fast acceleration a maps to level 1-a (codec._lz4_effort;
        # reference knob: flagstats.cpp:110)
        + [("lz4", 1 - a, f"fast_a{a}") for a in args.lz4_accels]
        + [("zstd", lv, f"c{lv}") for lv in args.zstd_levels]
        + [("raw", 0, "-")]
    )
    # warm the flagstat path once (the first call builds the kernels), so
    # the first row's flagstat column measures the same steady state
    _flagstat_array(arr, args.impl, args.device)
    print("codec\tconfig\tcomp_MB\tratio\tcomp_ms\tdecode_ms\t"
          "flagstat_ms\tdecode+flag_ms")
    for codec, lv, label in configs:
        with tempfile.TemporaryDirectory() as td:
            path = Path(td) / "sweep.bin"
            t0 = time.perf_counter()
            info = C.write_framed(path, arr, codec=codec, level=lv)
            t_comp = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = C.read_framed(path, codec, n_threads=args.threads)
            t_dec = time.perf_counter() - t0
            t0 = time.perf_counter()
            _flagstat_array(out, args.impl, args.device)
            t_flag = time.perf_counter() - t0
            ratio = info.raw_bytes / max(info.compressed_bytes, 1)
            print(f"{codec}\t{label}\t{info.compressed_bytes/1e6:.2f}\t"
                  f"{ratio:.2f}\t{t_comp*1e3:.1f}\t{t_dec*1e3:.1f}\t"
                  f"{t_flag*1e3:.1f}\t{(t_dec+t_flag)*1e3:.1f}")
    return 0


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
    from .bench.instrumented import rows, run_all

    lines = run_all(n=args.n, iters=args.iters, with_roofline=not args.no_roofline,
                    verbose=args.verbose, device=args.device)
    for line in lines:
        print(line)
    return 0 if all(line.endswith("\tok") for line in rows(lines)) else 1


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

    g = sub.add_parser("generate", help="synthetic FLAG vectors")
    g.add_argument("n", type=int)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--binary", help="write uint16 binary to this path")
    g.add_argument("--full-range", action="store_true")
    g.set_defaults(fn=_cmd_generate)

    u = sub.add_parser("utility", help="text FLAGs -> uint16 binary")
    u.add_argument("--input")
    u.add_argument("--output", "-o")
    u.set_defaults(fn=_cmd_utility)

    c = sub.add_parser("compress",
                       help="column (binary/.bam/.sam[.gz]) -> framed stream")
    c.add_argument("input")
    c.add_argument("--threads", type=int, default=0,
                   help="ingest threads (container inputs)")
    c.add_argument("--codec", choices=["raw", "lz4", "zstd"], default="lz4")
    c.add_argument("--level", type=int, default=1)
    c.add_argument("--block-bytes", type=int, default=None,
                   help="framed block size (default: CONFIG.block_bytes, "
                        "the reference-compatible 1,024,000)")
    c.add_argument("--output", "-o")
    c.set_defaults(fn=_cmd_compress)

    d = sub.add_parser("decompress", help="stream pipelines (reference bench modes)")
    d.add_argument("input")
    d.add_argument("--mode", choices=list("rdsRDS"), default="d",
                   help="r/d/s: framed decompress [+flagstat|+samtools]; "
                        "R/D/S: raw binary [+flagstat|+samtools]")
    d.add_argument("--codec", choices=["raw", "lz4", "zstd"], default="lz4")
    d.add_argument("--threads", type=int, default=0)
    d.add_argument("--impl", choices=sorted(FLAGSTAT_IMPLS), default=None)
    d.add_argument("--loop", action="store_true",
                   help="use the literal per-word loop for -s/-S")
    d.add_argument("--stream", action="store_true",
                   help="overlapped decode+count pipeline (mode d only)")
    d.add_argument("--timers", action="store_true",
                   help="print the stream pipeline's wall-time breakdown "
                        "(--stream only)")
    d.add_argument("--drop-caches", action="store_true",
                   help="drop the OS page cache first (cold-IO timing; "
                        "reference: flagstats.cpp clear_cache)")
    device_arg(d)
    d.set_defaults(fn=_cmd_decompress)

    f = sub.add_parser("flagstat", help="samtools-style report of any container "
                       "(.bam, .sam[.gz], framed .lz4/.zst, binary column)")
    f.add_argument("input")
    f.add_argument("--impl", choices=sorted(FLAGSTAT_IMPLS), default=None)
    f.add_argument("--threads", type=int, default=0,
                   help="reader threads (container input; 0 = all cores)")
    device_arg(f)
    f.set_defaults(fn=_cmd_flagstat)

    b2 = sub.add_parser("bam2flags",
                        help="extract the uint16 FLAG column from a BAM or SAM")
    b2.add_argument("input")
    b2.add_argument("--output", "-o")
    b2.add_argument("--threads", type=int, default=0)
    b2.set_defaults(fn=_cmd_bam2flags)

    s = sub.add_parser("codec-sweep",
                       help="compression/decode/flagstat sweep over codec levels")
    s.add_argument("input")
    s.add_argument("--lz4-levels", type=int, nargs="*", default=[1, 4, 9])
    s.add_argument("--lz4-accels", type=int, nargs="*", default=[],
                   help="LZ4-fast acceleration values (reference a2-10)")
    s.add_argument("--zstd-levels", type=int, nargs="*", default=[1, 3, 19])
    s.add_argument("--threads", type=int, default=0)
    s.add_argument("--impl", choices=sorted(FLAGSTAT_IMPLS), default=None)
    device_arg(s)
    s.set_defaults(fn=_cmd_codec_sweep)

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
    except (ValueError, OSError, RuntimeError, EOFError, zlib.error) as e:
        # a bad argument or input, or no card: one clean line, nonzero
        # rc (the reference's run_screaming pattern,
        # flagstats.cpp:105-108). EOFError / zlib.error are what
        # truncated or garbled gzip streams raise mid-read.
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

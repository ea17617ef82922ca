"""Kernel grid-size sweep on the card.

The port of tools/kernel_sweep.py. The TPU kernels are tuned by their
grid-step depth ``nblk``; a CUDA kernel whose blocks stride over the
input has one such knob, the number of blocks in its grid (``blocks=``
of the wrappers; default: one full wave, every block resident at once).
At 64Mi full-range words this tool first holds each kernel, at each grid
size, against the cached host oracle (all 32 counters;
``flags.REPORT_COUNTERS`` in report mode), then times it with the gated
multi-K fit (bench/harness.py), launch cost excluded:

  full, report                  K1 over raw words
  pre_full, pre_report          K2 over 32-row plane tiles
  pre_packed_full, _report      K2 over packed 24- / 20-row tiles
  words                         K6 over raw words

each at 1/2, 1, 2 and 4 waves. Rates are on the bytes a kernel reads
(2 per raw word; 4 KiB per group per plane row its mode reads), against
the defended read roofline; the packed rows also print the rate in
words-equivalent bytes, so the layout's gain shows beside the rows above.

Run on the card: python -m libflagstats_tpu_torch.tools.kernel_sweep
Exits 1 on any MISMATCH, and with one line when there is no card.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..ops import kernels as K
from ..ops import words_kernels as W

N_WORDS = 64 * 1024 * 1024
WAVES = (0.5, 1, 2, 4)     # grid sizes, in waves
KS = (4, 64, 260)          # repetition counts of the fits
FIT_ITERS = 4
FIT_ATTEMPTS = 5
#: the wave a CPU run (the plain versions; they ignore the grid) sweeps over
CPU_WAVE_BLOCKS = 8


def _configs(dev: torch.device) -> list:
    """(mode name, input key, body(arg, blocks), wave blocks, report,
    packed). A body returns what its kernel returns; the input key names
    the layout (bench/kernels._inputs): raw words or plane tiles."""
    def wave(query):
        return query(dev) if dev.type == "cuda" else CPU_WAVE_BLOCKS

    def k1(name, mode, report):
        return (name, "x", lambda a, b: K.stream_sums_cuda(a, mode, blocks=b),
                wave(lambda d: K.wave_blocks(mode, d)), report, False)

    def k2(name, key, report, packed):
        rows = len(K.packed_rows_for(report)) if packed else K.REGS
        return (name, key, lambda p, b: K.stream_sums_pre_cuda(p, report, packed, blocks=b),
                wave(lambda d: K.wave_blocks("pre_report" if report else "pre", d, rows)),
                report, packed)

    return [
        k1("report", "flagstat_report", True),
        k1("full", "flagstat", False),
        k2("pre_report", "pre", True, False),
        k2("pre_full", "pre", False, False),
        k2("pre_packed_report", "packed_report", True, True),
        k2("pre_packed_full", "packed_full", False, True),
        ("words", "x", lambda a, b: torch.cat(W.stream_sums_words_cuda(a, blocks=b)),
         wave(lambda d: K.wave_blocks("words", d)), False, False),
    ]


def run(n_words: int = N_WORDS, device=None, cache_dir: str | None = None) -> dict:
    """The sweep over ``n_words`` seeded words on ``device`` (default:
    the current CUDA device; raises with no card unless device="cpu").
    Prints its lines as it goes; returns {"ok", "lines", "times"
    ((mode, waves) -> seconds)}."""
    from ..bench import kernels as roster
    from ..bench.harness import defended_roofline, gated_kernel_time_fit, timing_device
    from ..bench.refcache import oracle_counters
    from ..oracle import generate_flags

    dev = timing_device(device)
    n = n_words
    x_host = generate_flags(n, seed=0, full_range=True)
    ref = oracle_counters(x_host, n, seed=0, full_range=True, cache_dir=cache_dir)
    lines = []

    def say(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    roof = defended_roofline(2 * n, ks=KS, device=dev)
    if roof != roof:  # NaN: no sample passed the gates; None disables the
        roof = None   # throughput gate explicitly (a NaN compares False)
    say("roofline (agreed): " + (f"{roof / 1e9:.1f} GB/s" if roof else
                                 "n/a: no gate-passing sample; reject-above-roofline gate off"))

    configs = _configs(dev)
    args = roster._inputs(x_host, dev, {key for _, key, *_ in configs})
    ok_all = True
    times = {}
    for mode, key, body, wave_blocks, report, packed in configs:
        arg = args[key]
        kind = "streams" if mode == "words" else "report" if report else "full"
        # what the kernel reads: 2 bytes per raw word; of plane tiles, 4 KiB
        # per group per row the mode reads (K2 skips the others)
        n_bytes = 2 * n if key == "x" else arg.shape[0] * len(K.packed_rows_for(report)) * 4096
        for waves in WAVES:
            blocks = max(1, int(waves * wave_blocks))
            ok = roster.counters_ok(body(arg, blocks), kind, n, ref)
            ok_all &= ok
            fit = gated_kernel_time_fit(lambda a, blocks=blocks: body(a, blocks), arg,
                                        roof_bytes_per_s=roof, n_bytes=n_bytes, ks=KS,
                                        iters=FIT_ITERS, attempts=FIT_ATTEMPTS, device=dev)
            t = times[(mode, waves)] = fit.slope_s
            gbs = n_bytes / t / 1e9
            own = (f"{gbs:.1f} GB/s own-bytes ({2.0 * n / t / 1e9:.0f} GB/s words-equiv)"
                   if packed else f"{gbs:.1f} GB/s")
            vs = f"{gbs * 1e9 / roof:.3f}x roofline" if roof else "n/a roofline"
            say(f"mode={mode} blocks={blocks} ({waves:g} waves): {t * 1e3:.4f} ms, {own}, "
                f"{vs}{'' if fit.gate_passed else '!'}, {'OK' if ok else 'MISMATCH'}")
    return {"ok": ok_all, "lines": lines, "times": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_sweep")
    ap.add_argument("-n", "--n-words", type=int, default=N_WORDS)
    ap.add_argument("--device", default=None, help="'cpu' runs the plain versions on the CPU")
    args = ap.parse_args(argv)
    try:
        # a bit-exactness violation must fail the exit code, not just print
        return 0 if run(args.n_words, args.device)["ok"] else 1
    except RuntimeError as e:  # no card: one line, no fallback
        print(f"kernel_sweep: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

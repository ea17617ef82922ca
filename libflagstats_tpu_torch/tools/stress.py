"""Randomized differential stress: random sizes x seeds x value ranges.

The port of tools/stress.py. It mirrors the reference's
fuzz-while-benchmarking discipline (linux/instrumented_benchmark.cpp:
174-208) as a standalone sweep: each round draws a size below
``max_words`` and a value range (flags below 4096, or the full 16 bits),
counts the words with every implementation and holds each against
``flagstat_numpy``, and that, up to ``loop_oracle_max`` words, against
the branchy per-word ``flagstat_loop`` on the defined counters. The seed
is printed first, so a MISMATCH can be reproduced.

The implementations: ``numpy``, ``native`` (where g++ builds the host
library) and ``torch`` on the device, and on the card ``cuda``,
``cuda_report`` (held on ``flags.REPORT_COUNTERS`` only), ``cuda_pre``
and ``cuda_words``: K1, K3, K2 and K6 on ragged sizes. The JAX tool
counts on the CPU unless asked for the TPU (``--tpu``); this one counts
on the card unless asked for the CPU (``--device cpu``: numpy, native
and torch there).

Run on the card:
  python -m libflagstats_tpu_torch.tools.stress [--rounds 50] [--max-words 2000000] [--seed S]
Exits 1 on a MISMATCH, and with one line when there is no card.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import flags as F
from ..ops import dispatch as D
from ..ops import native_host
from ..oracle import flagstat_loop, flagstat_numpy

#: the impls run on the card besides the host ones and the torch tier
CARD_IMPLS = ("cuda", "cuda_report", "cuda_pre", "cuda_words")


def impls_for(device) -> list[str]:
    """The impls a run on ``device`` checks, in order."""
    impls = ["numpy"] + (["native"] if native_host.available() else []) + ["torch"]
    if device.type == "cuda":
        impls += list(CARD_IMPLS)
    return impls


def run(rounds: int = 50, max_words: int = 2_000_000, loop_oracle_max: int = 30_000,
        seed: int | None = None, device=None) -> dict:
    """``rounds`` random rounds on ``device`` (default: the card; raises
    with no card unless device="cpu"). Prints its lines as it goes;
    returns {"ok", "lines", "seed", "impls", "rounds" ([(n, hi)])}."""
    D.auto_impl(0, device)   # no card and no device asked for: raise
    dev = torch.device("cuda" if device is None else device)
    impls = impls_for(dev)
    seed = seed if seed is not None else int(time.time())
    lines = []

    def say(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    def done(ok: bool) -> dict:
        return {"ok": ok, "lines": lines, "seed": seed, "impls": impls, "rounds": drawn}

    say(f"[stress] seed={seed} (rerun with --seed {seed} to reproduce)")
    rng = np.random.default_rng(seed)
    tested = list(F.TESTED_COUNTERS)
    report_idx = list(F.REPORT_COUNTERS)
    drawn = []
    t0 = time.time()
    for r in range(rounds):
        n = int(rng.integers(0, max_words))
        hi = int(rng.choice([0x1000, 0x10000]))
        x = rng.integers(0, hi, size=n, dtype=np.uint16)
        drawn.append((n, hi))
        ref = flagstat_numpy(x).astype(np.int64)
        checks = []
        if n <= loop_oracle_max:
            checks.append(("flagstat_loop", tested, flagstat_loop(x).astype(np.int64)))
        for impl in impls:
            got = np.asarray(D.flagstats_u16(x, impl=impl, device=dev), dtype=np.int64)
            checks.append((impl, report_idx if impl == "cuda_report" else list(range(32)), got))
        for impl, idx, got in checks:
            if not (got[idx] == ref[idx]).all():
                say(f"MISMATCH round={r} impl={impl} n={n} hi={hi:#x} seed={seed}")
                say(f"ref: {ref}")
                say(f"got: {got}")
                return done(False)
        if (r + 1) % 10 == 0:
            say(f"[{r + 1}/{rounds}] ok ({time.time() - t0:.1f}s)")
    say(f"stress OK: {rounds} rounds x {len(impls)} impls")
    return done(True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stress")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--max-words", type=int, default=2_000_000)
    ap.add_argument("--loop-oracle-max", type=int, default=30_000,
                    help="cap for the slow per-word loop oracle cross-check")
    ap.add_argument("--seed", type=int, default=None,
                    help="RNG seed (default: time-derived; always printed so a MISMATCH "
                         "can be reproduced)")
    ap.add_argument("--device", default=None,
                    help="'cpu' checks the host impls and the torch tier on the CPU")
    args = ap.parse_args(argv)
    try:
        out = run(args.rounds, args.max_words, args.loop_oracle_max, args.seed, args.device)
    except RuntimeError as e:  # no card: one line, no fallback
        print(f"stress: error: {e}", file=sys.stderr)
        return 1
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

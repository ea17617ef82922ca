"""Device-stream balance on the card: does decode and copy overlap the count?

The port of tools/pipeline_balance.py. The streaming device path
(io/stream.py) is built to overlap decode, host transpose, the copy to
the card and the count. This tool measures that over one framed LZ4
stream, three ways:

  overlapped  the pipeline as shipped (``flagstat_stream``)
  serial      the same pipeline, but the device is synchronised after
              every chunk's count, so nothing can overlap it: the
              baseline the overlap is judged against
  native      the host's fused decode + count, for scale

with legs for the raw-word kernel (``cuda``) and for the host transpose
+ plane-tile kernel (``cuda_pre``); with device="cpu" one pair of legs
through the plain torch tier. An untimed warm-up run per impl comes
first. Each leg runs ``RUNS`` times (host walls move by +-15% from run
to run and between machines, as much as the rule's margin), an impl's
overlapped and serial runs taking turns (o, s, o, s, ...) so that a
drift of the host lands on both; it prints every run's wall and is
priced at its fastest run; every run is held against the host oracle,
and the fastest prints its ``SectionTimer`` table.
serial / overlapped > 1.15 counts as real overlap; about 1 means the
pipeline runs serially anyway (the host stages, not the device, set its
wall).

The serial legs swap ``io.stream._chunk_sums`` for the length of one run.

Run on the card:
  python -m libflagstats_tpu_torch.tools.pipeline_balance [--n-words N] [--level L]
Exits 1 with one line when there is no card, and 1 when a leg's counters
are wrong.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..bench.profiling import SectionTimer
from ..io import codec as C
from ..io import stream as S
from ..oracle import flagstat_numpy, generate_flags

N_WORDS = 103_067_736      # 1/8 of the NA12878 column
OVERLAP_MIN = 1.15         # serial / overlapped above this counts as overlap
RUNS = 3                   # runs per leg; a leg's wall is the fastest


def _run(path, impl, timer, serial: bool, device):
    """One streamed count -> (counters, wall seconds)."""
    orig = S._chunk_sums

    def serial_sums(tally, chunk):
        orig(tally, chunk)
        if chunk.device.type == "cuda":
            torch.cuda.synchronize(chunk.device)   # force completion: forbid any overlap

    if serial:
        S._chunk_sums = serial_sums
    try:
        t0 = time.perf_counter()
        counters = S.flagstat_stream(path, codec="lz4", impl=impl, timer=timer, device=device)
        wall = time.perf_counter() - t0
    finally:
        S._chunk_sums = orig
    return counters, wall


def run(n_words: int = N_WORDS, level: int = 1, skip_native: bool = False,
        device=None) -> dict:
    """Every leg over ``n_words`` seeded words on ``device`` (default:
    the current CUDA device; raises with no card unless device="cpu"),
    RUNS times each. Prints as it goes; returns {"ok", "walls" (leg ->
    its fastest run's seconds), "runs" (leg -> every run's seconds),
    "benefit" (overlapped leg -> serial / overlapped), "lines"}."""
    from ..bench.harness import timing_device

    dev = timing_device(device)
    impls = ("cuda", "cuda_pre") if dev.type == "cuda" else ("torch",)
    lines = []

    def say(text: str) -> None:
        lines.extend(text.splitlines())
        print(text, flush=True)

    say(f"device={torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev} "
        f"impls={','.join(impls)} n_words={n_words}")
    x = generate_flags(n_words, seed=0, full_range=True)
    ref = flagstat_numpy(x).astype(np.int64)
    walls, all_walls, benefit = {}, {}, {}
    ok_all = True
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "balance.lz4"
        C.write_framed(path, x, codec="lz4", level=level)
        say(f"framed stream: {path.stat().st_size / 1e6:.1f} MB")
        # one round: a run of each leg in it, in turn
        rounds = []
        for impl in impls:
            suffix = "" if impl == impls[0] else f"_{impl.split('_')[-1]}"
            rounds.append([(f"overlapped{suffix}", impl, False), (f"serial{suffix}", impl, True)])
        if not skip_native:
            rounds.append([("native", "native", False)])
        for impl in impls:
            # first-use costs (the kernels' build and first launch, the
            # pinned ring's first allocation) belong to no leg
            _, wall = _run(path, impl, SectionTimer(), False, dev)
            say(f"warm-up [{impl}]: wall {wall:.3f}s (not a leg)")
        for legs in rounds:
            tried = {name: [] for name, _, _ in legs}
            for _ in range(RUNS):
                for name, impl, serial in legs:
                    timer = SectionTimer()
                    counters, wall = _run(path, impl, timer, serial,
                                          None if impl == "native" else dev)
                    ok = bool((counters.astype(np.int64) == ref).all())
                    tried[name].append((wall, timer, ok))
            for name, runs in tried.items():
                ok = all(t[2] for t in runs)
                ok_all &= ok
                wall, timer, _ = min(runs, key=lambda t: t[0])
                walls[name], all_walls[name] = wall, [t[0] for t in runs]
                say(f"\n== {name}: wall {wall:.3f}s, the fastest of "
                    f"{' '.join(f'{t[0]:.3f}s' for t in runs)} "
                    f"({n_words / wall / 1e6:.1f} Mwords/s) check={'ok' if ok else 'FAIL'}")
                say(timer.report())
    for name in walls:
        if name.startswith("overlapped"):
            ov, se = walls[name], walls[name.replace("overlapped", "serial")]
            benefit[name] = se / ov
            verdict = ("real overlap" if se / ov > OVERLAP_MIN
                       else "no-op: the pipeline runs serially anyway")
            say(f"\noverlap benefit [{name}]: serial {se:.3f}s / overlapped {ov:.3f}s = "
                f"{se / ov:.2f}x ({verdict})")
    return {"ok": ok_all, "walls": walls, "runs": all_walls, "benefit": benefit,
            "lines": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pipeline_balance")
    ap.add_argument("--n-words", type=int, default=N_WORDS,
                    help="1/8 of the NA12878 column by default")
    ap.add_argument("--level", type=int, default=1)
    ap.add_argument("--skip-native", action="store_true")
    ap.add_argument("--device", default=None, help="'cpu' streams through the torch tier")
    args = ap.parse_args(argv)
    try:
        return 0 if run(args.n_words, args.level, args.skip_native, args.device)["ok"] else 1
    except RuntimeError as e:  # no card: one line, no fallback
        print(f"pipeline_balance: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

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
first; every leg is held against the host oracle and prints its
``SectionTimer`` table. serial / overlapped > 1.15 counts
as real overlap; about 1 means the pipeline runs serially anyway (the
host stages, not the device, set its wall).

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


def _run(path, impl, timer, serial: bool, device):
    """One streamed count -> (counters, wall seconds)."""
    orig = S._chunk_sums

    def serial_sums(*args):
        c, f = orig(*args)
        if c.device.type == "cuda":
            torch.cuda.synchronize(c.device)   # force completion: forbid any overlap
        return c, f

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
    the current CUDA device; raises with no card unless device="cpu").
    Prints as it goes; returns {"ok", "walls" (leg -> seconds),
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
    walls, benefit = {}, {}
    ok_all = True
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "balance.lz4"
        C.write_framed(path, x, codec="lz4", level=level)
        say(f"framed stream: {path.stat().st_size / 1e6:.1f} MB")
        legs = []
        for impl in impls:
            suffix = "" if impl == impls[0] else f"_{impl.split('_')[-1]}"
            legs += [(f"overlapped{suffix}", impl, False), (f"serial{suffix}", impl, True)]
        if not skip_native:
            legs.append(("native", "native", False))
        for impl in impls:
            # first-use costs (the kernels' build and first launch, the
            # pinned ring's first allocation) belong to no leg
            _, wall = _run(path, impl, SectionTimer(), False, dev)
            say(f"warm-up [{impl}]: wall {wall:.3f}s (not a leg)")
        for name, impl, serial in legs:
            timer = SectionTimer()
            counters, wall = _run(path, impl, timer, serial,
                                  None if impl == "native" else dev)
            ok = bool((counters.astype(np.int64) == ref).all())
            ok_all &= ok
            walls[name] = wall
            say(f"\n== {name}: wall {wall:.3f}s ({n_words / wall / 1e6:.1f} Mwords/s) "
                f"check={'ok' if ok else 'FAIL'}")
            say(timer.report())
    for name in walls:
        if name.startswith("overlapped"):
            ov, se = walls[name], walls[name.replace("overlapped", "serial")]
            benefit[name] = se / ov
            verdict = ("real overlap" if se / ov > OVERLAP_MIN
                       else "no-op: the pipeline runs serially anyway")
            say(f"\noverlap benefit [{name}]: serial {se:.3f}s / overlapped {ov:.3f}s = "
                f"{se / ov:.2f}x ({verdict})")
    return {"ok": ok_all, "walls": walls, "benefit": benefit, "lines": lines}


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

"""Full codec sweep over the synthetic NA12878 FLAG column.

The port of tools/codec_sweep_na12878.py, mirroring the reference's
published table (README.md:136-175): the same 39 configs in the same
order, LZ4-HC c2-9, LZ4-fast a1-10, Zstd c1-20 and raw, over
``datasets.synth_na12878(scale)`` (default 1/8 of NA12878).

Columns: compressed size, ratio, compress time, warm decode time (the
native thread pool), decode + flagstat time, and the fused native
pipeline (``native_host.flagstat_framed_native``: map, then decode and
count block by block, the host's end-to-end path). The separate
flagstat term is codec-independent and measured once: the port's tier,
a warm minimum of 3 ``flagstats_u16`` calls on the column resident on
the card (K1), the card synchronized (the JAX tool times its forced-CPU
XLA tier). ``--device cpu`` takes the torch tier on the CPU. The term is
held against ``flagstat_numpy``, and once per codec family the decoded
column is counted on the same tier and held against it too, as are the
fused pipeline's counters.

Zstd goes through the host library's zstd route (the system header, or
the compat declarations where the image has the runtime library only;
``io/native_lib.ZSTD_ROUTE``).

Run on the card:
  python -m libflagstats_tpu_torch.tools.codec_sweep_na12878 [scale] [--device cpu]
Exits 1 with one line when there is no card and no device is asked for,
and 1 on any mismatch.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..datasets import synth_na12878
from ..io import codec as C
from ..ops import dispatch as D
from ..ops import native_host
from ..oracle import flagstat_numpy

HEADER = ("codec\tconfig\tcomp_MB\tratio\tcomp_s\tdecode_ms\tdecode_flagstat_ms\t"
          "fused_native_ms")
#: (codec, level, label): the reference's table, in its order
CONFIGS = ([("lz4", lv, f"HC_c{lv}") for lv in range(2, 10)]
           + [("lz4", 1, "fast_a1")]
           + [("lz4", 1 - a, f"fast_a{a}") for a in range(2, 11)]
           + [("zstd", lv, f"c{lv}") for lv in range(1, 21)]
           + [("raw", 0, "-")])
FLAG_RUNS = 3


def flagstat_term(x: np.ndarray, device) -> tuple[float, np.ndarray]:
    """(seconds, counters): the warm minimum of FLAG_RUNS counts of the
    column resident on ``device`` (the card's K1, or the torch tier on
    the CPU). Each count returns the counters to the host, so the card
    has finished when the clock stops."""
    xd = torch.from_numpy(x).to(device)
    got = D.flagstats_u16(xd, device=device)     # the first call builds and warms
    best = float("inf")
    for _ in range(FLAG_RUNS):
        if xd.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        D.flagstats_u16(xd, device=device)
        best = min(best, time.perf_counter() - t0)
    return best, got.astype(np.int64)


def run(scale: int = 8, device=None) -> dict:
    """The sweep at 1/``scale`` of NA12878 on ``device`` (default: the
    card; raises with no card unless device="cpu"). Prints the table as
    it goes; returns {"lines", "rows", "flag_s", "checked" (the codec
    families whose counters were held against the oracle)}. Raises
    AssertionError on a count that differs from it."""
    D.auto_impl(0, device)   # no card and no device asked for: raise, before the column
    dev = torch.device("cuda" if device is None else device)
    x, _ = synth_na12878(scale_divisor=scale, seed=0)
    print(f"# {x.size} words (NA12878/{scale} synthetic)", file=sys.stderr)
    ref = flagstat_numpy(x).astype(np.int64)
    t_flag, got = flagstat_term(x, dev)
    if not (got == ref).all():
        raise AssertionError(f"the flagstat term on {dev} differs from flagstat_numpy")
    # three decimals: on the card the term is a fraction of a millisecond
    print(f"# flagstat ({D.auto_impl(x.size, dev)} tier on {dev}, codec-independent): "
          f"{t_flag * 1e3:.3f} ms", file=sys.stderr)

    have_native = native_host.available()
    checked = []
    lines, rows = [HEADER], []
    print(HEADER, flush=True)
    for codec, lv, label in CONFIGS:
        with tempfile.TemporaryDirectory() as td:
            p = Path(td) / "s.bin"
            t0 = time.perf_counter()
            info = C.write_framed(p, x, codec=codec, level=lv)
            t_comp = time.perf_counter() - t0
            t_dec = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                out = C.read_framed(p, codec)
                t_dec = min(t_dec, time.perf_counter() - t0)
            t_fused, counters = float("nan"), None
            if have_native:
                t_fused = float("inf")
                for _ in range(2):
                    t0 = time.perf_counter()
                    counters, nw = native_host.flagstat_framed_native(p, C._codec_id(codec))
                    t_fused = min(t_fused, time.perf_counter() - t0)
                if nw != x.size:
                    raise AssertionError(f"{codec} {label}: the fused pipeline read {nw} "
                                         f"words of {x.size}")
        if codec not in checked:
            separate = D.flagstats_u16(out, device=dev).astype(np.int64)
            fused = None if counters is None else counters.astype(np.int64)
            checked.append(codec)
            if not (np.array_equal(out, x) and (separate == ref).all()
                    and (fused is None or (fused == ref).all())):
                raise AssertionError(f"{codec} {label}: counters differ from flagstat_numpy "
                                     f"(separate {separate.tolist()}, fused "
                                     f"{None if fused is None else fused.tolist()})")
        ratio = info.raw_bytes / max(info.compressed_bytes, 1)
        row = {"codec": codec, "config": label, "comp_mb": info.compressed_bytes / 1e6,
               "ratio": ratio, "comp_s": t_comp, "decode_ms": t_dec * 1e3,
               "decode_flagstat_ms": (t_dec + t_flag) * 1e3, "fused_native_ms": t_fused * 1e3}
        rows.append(row)
        line = (f"{codec}\t{label}\t{row['comp_mb']:.2f}\t{ratio:.2f}\t{t_comp:.2f}\t"
                f"{row['decode_ms']:.0f}\t{row['decode_flagstat_ms']:.0f}\t"
                f"{row['fused_native_ms']:.0f}")
        lines.append(line)
        print(line, flush=True)
    return {"lines": lines, "rows": rows, "flag_s": t_flag, "checked": checked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="codec_sweep_na12878")
    ap.add_argument("scale", nargs="?", type=int, default=8,
                    help="divide the 824M-read dataset by this factor")
    ap.add_argument("--device", default=None, help="'cpu' counts with the torch tier")
    args = ap.parse_args(argv)
    try:
        run(args.scale, args.device)
    except RuntimeError as e:   # no card: one line, no fallback
        print(f"codec_sweep_na12878: error: {e}", file=sys.stderr)
        return 1
    except AssertionError as e:
        print(f"codec_sweep_na12878: MISMATCH: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

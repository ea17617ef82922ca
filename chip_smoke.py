#!/usr/bin/env python3
"""End-to-end check of libflagstats_tpu_torch on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ops/csrc/ (into build/torch_kernels/),
holds every kernel mode against its plain torch version and the host
oracles at edge sizes, drives the public entry points at full scale
(64Mi full-range words, and the 824,541,892-word synthetic NA12878
column), times each kernel against its plain version with CUDA events,
and prints one JSON line of kernel results, the card's name and power
limit, and last, one JSON line {"ok": true, "device": {...}}. Any failed
phase raises, and the script exits nonzero with no result line. It
imports no jax and nothing of libflagstats_tpu.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.datasets import na12878_report_values, synth_na12878
from libflagstats_tpu_torch.ops import bitslice as B
from libflagstats_tpu_torch.ops import cuda_build
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops.torch_ops import assemble_counters
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags

WORDS_64MI = 64 << 20
SOURCE = "libflagstats_tpu_torch/ops/csrc/flagstat_kernels.cu"
REPLACES = "libflagstats_tpu/ops/pallas_kernels.py:403"
REPORT_ZEROS = [1, 3, 4, 5, 17, 19, 20, 21]
NA12878_SKIP = [F.FREVERSE_OFF, F.FMREVERSE_OFF, 16 + F.FREVERSE_OFF, 16 + F.FMREVERSE_OFF]


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def pospopcnt_np(x: np.ndarray) -> np.ndarray:
    x32 = x.astype(np.uint32)
    return np.array([np.count_nonzero((x32 >> k) & 1) for k in range(16)], np.int64)


def counters_from_sums(sums: torch.Tensor, mode: str, n: int) -> np.ndarray:
    total, fail = K._sums_to_streams(sums, mode == "flagstat_report")
    return assemble_counters(total, fail, n).cpu().numpy()


def make_words(kind: str, n: int) -> np.ndarray:
    if kind == "flags<4096":
        return generate_flags(n, seed=n, full_range=False)
    if kind == "full16bit":
        return generate_flags(n, seed=n + 1, full_range=True)
    value = {"all 0xFFFF": 0xFFFF, "all 0x0FFF": 0x0FFF, "all zero": 0}[kind]
    return np.full(n, value, dtype=np.uint16)


def check_kernels(max_err: dict) -> None:
    """Phase 3: kernel = plain = host oracle, exactly, for every mode."""
    wave = max(K.wave_words(m) for m in K.MODES)
    sizes = [0, 1, 31, 32, 33, 63, 64, 65, 4095, 65535, 65536, 65537,
             (1 << 20) + 777, 2 * wave + 12345]
    kinds = ["flags<4096", "full16bit", "all 0xFFFF", "all 0x0FFF", "all zero"]
    print(f"one wave of blocks covers {wave} words; largest size {sizes[-1]}")
    cases = dict.fromkeys(K.MODES, 0)
    for n in sizes:
        for kind in kinds:
            x = make_words(kind, n)
            ref = flagstat_numpy(x).astype(np.int64)
            spec = B.flagstat_bitsliced_np(x).astype(np.int64)
            assert (spec == ref).all(), (n, kind, "bitsliced spec vs oracle")
            pos = pospopcnt_np(x)
            buf = torch.from_numpy(np.concatenate([np.zeros(1, np.uint16), x])).cuda()
            for offset, xd in (("aligned", buf[1:].clone()), ("odd-offset slice", buf[1:])):
                for mode in K.MODES:
                    got = K.stream_sums_cuda(xd, mode)
                    plain = K.stream_sums_plain(xd, mode)
                    torch.cuda.synchronize()
                    err = int((got - plain).abs().max()) if got.numel() else 0
                    max_err[mode] = max(max_err[mode], err)
                    where = (mode, n, kind, offset)
                    assert err == 0, (where, got.tolist(), plain.tolist())
                    if mode == "pospopcnt":
                        assert (got.cpu().numpy() == pos).all(), where
                    else:
                        c = counters_from_sums(got, mode, n)
                        if mode == "flagstat":
                            assert (c == ref).all(), (where, c, ref)
                        else:
                            idx = list(F.REPORT_COUNTERS)
                            assert (c[idx] == ref[idx]).all(), (where, c, ref)
                            assert (c[REPORT_ZEROS] == 0).all(), where
                    cases[mode] += 1
    for mode in K.MODES:
        print(f"kernel {mode}: {cases[mode]} cases, kernel = plain = oracle "
              f"exactly (max_abs_err {max_err[mode]})")


def launched(before: dict, mode: str) -> None:
    assert K.LAUNCHES[mode] > before[mode], f"{mode} kernel was not launched"
    before.update(K.LAUNCHES)


def drive_main_path() -> dict:
    """Phase 4: the public entry points at full scale."""
    seen = dict(K.LAUNCHES)
    x = generate_flags(WORDS_64MI, seed=7, full_range=True)
    ref = flagstat_numpy(x)
    assert D.auto_impl(x.size) == "cuda"

    # (a) 64Mi full-range words, from the host and from a device tensor
    c = L.flagstats_u16(x)
    launched(seen, "flagstat")
    assert (c == ref).all(), (c, ref)
    xd = torch.from_numpy(x).cuda()
    assert (L.flagstats_u16(xd) == ref).all()
    launched(seen, "flagstat")
    r = L.flagstats_u16(x, impl="cuda_report")
    launched(seen, "flagstat_report")
    idx = list(F.REPORT_COUNTERS)
    assert (r[idx] == ref[idx]).all() and (r[REPORT_ZEROS] == 0).all()
    p = L.pospopcnt_u16(x)
    launched(seen, "pospopcnt")
    assert (p.astype(np.int64) == pospopcnt_np(x)).all()
    d = L.flagstats(x)
    launched(seen, "flagstat")
    assert d == L.counters_to_dict(ref, x.size)
    print("main path (a): flagstats_u16, cuda_report, pospopcnt_u16, flagstats "
          "on 64Mi full-range words = oracle")

    # (c) out= accumulation over three blocks = one call
    acc = np.zeros(32, dtype=np.uint64)
    for block in np.array_split(x, 3):
        L.flagstats_u16(block, out=acc)
        launched(seen, "flagstat")
    assert (acc == c).all()
    print("main path (c): out= over three blocks = one call")

    # (d) a small DEVICE_WORD_CAP splits the stream into exact sub-calls
    cap = D.DEVICE_WORD_CAP
    D.DEVICE_WORD_CAP = 10_000_003
    try:
        chunked = L.flagstats_u16(x)
        launched(seen, "flagstat")
        chunked_pos = L.pospopcnt_u16(x)
        launched(seen, "pospopcnt")
    finally:
        D.DEVICE_WORD_CAP = cap
    assert (chunked == ref).all() and (chunked_pos == p).all()
    print(f"main path (d): DEVICE_WORD_CAP=10,000,003 "
          f"({-(-x.size // 10_000_000)} chunks) = oracle")
    del xd

    # (b) the full synthetic NA12878 column
    t0 = time.perf_counter()
    arr, expected = synth_na12878(1)
    print(f"synth_na12878(1): {arr.size} words, shuffled, "
          f"made on the host in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    c = L.flagstats_u16(arr)
    wall = time.perf_counter() - t0
    launched(seen, "flagstat")
    keep = [i for i in range(32) if i not in NA12878_SKIP]
    assert (c[keep] == expected[keep]).all(), (c, expected)
    report = L.counters_to_report(c)
    want = na12878_report_values(1)
    assert {k: getattr(report, k)[0] for k in want} == want, report
    assert all(getattr(report, k)[1] == 0 for k in want), report
    r = L.flagstats_u16(arr, impl="cuda_report")
    launched(seen, "flagstat_report")
    assert L.counters_to_report(r) == report
    print(f"main path (b): NA12878 {arr.size} words, report = "
          f"na12878_report_values(1) (flagstats_u16 host wall incl. H2D "
          f"{wall:.3f} s)")
    print(report.text())
    return arr


def median_ms(fn, runs: int, reps: int) -> float:
    """Median over ``runs`` of the CUDA-event time of ``reps`` calls, per call.
    A spin kernel first lets the host queue the calls ahead of the card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def time_kernels(na_words: np.ndarray, card: str) -> dict:
    """Phase 5: kernel against plain version, CUDA events, median of runs."""
    times = {}
    x64 = torch.from_numpy(generate_flags(WORDS_64MI, seed=11, full_range=True)).cuda()
    na = torch.from_numpy(na_words).cuda()
    shapes = [("64Mi", x64, K.MODES), ("NA12878", na, ("flagstat",))]
    for label, x, modes in shapes:
        n = x.numel()
        # n is even; an int32 view sums at a fraction of the read rate, a
        # float32 view (any bit pattern) streams close to it
        read_ms = median_ms(lambda: x.view(torch.float32).sum(), 7, 10)
        print(f"[{card}] {label} {n} words: torch float32-view sum over the same "
              f"bytes (read reference, not a kernel of the port) {read_ms:.4f} ms = "
              f"{2 * n / read_ms / 1e6:.1f} GB/s")
        for mode in modes:
            ms = median_ms(lambda: K.stream_sums_cuda(x, mode), 7, 10)
            plain_ms = median_ms(lambda: K.stream_sums_plain(x, mode), 5, 1)
            times[(label, mode)] = (ms, plain_ms)
            for name, t in (("kernel", ms), ("plain", plain_ms)):
                print(f"[{card}] {label} {mode} {name}: {t:.4f} ms, "
                      f"{n / t / 1e6:.4g} Gwords/s, {2 * n / t / 1e6:.1f} GB/s read")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch sees none")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    path = cuda_build.build()
    cuda_build.load()
    print(f"built {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    max_err = dict.fromkeys(K.MODES, 0)
    check_kernels(max_err)

    for mode in K.MODES:
        K.LAUNCHES[mode] = 0
    na_words = drive_main_path()
    launches = dict(K.LAUNCHES)
    print(f"main-path launches: {launches}")
    assert all(launches[m] > 0 for m in K.MODES), launches

    times = time_kernels(na_words, card)
    assert "jax" not in sys.modules and "libflagstats_tpu" not in sys.modules

    kernels = [{
        "name": f"stream_sums_kernel<{mode}>",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches[mode],
        "max_abs_err": max_err[mode],
        "ms": times[("64Mi", mode)][0],
        "plain_ms": times[("64Mi", mode)][1],
    } for mode in K.MODES]
    print(json.dumps({"kernels": kernels}))
    print(card)  # as nvidia-smi --query-gpu=name,power.limit prints it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

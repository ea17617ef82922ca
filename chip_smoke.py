#!/usr/bin/env python3
"""End-to-end check of libflagstats_tpu_torch on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ops/csrc/ (into build/torch_kernels/)
and the native host library (into build/torch_host/), holds every
kernel against its plain torch version and the host oracles at edge
sizes, drives the public entry points at full scale (64Mi full-range
words, the 824,541,892-word synthetic NA12878 column, and that column
written as a framed LZ4 file of ~0.83 GB in a temporary directory and
streamed back through flagstat_stream, then counted by the data-parallel
path: two shards on the card, two gloo worker processes over the file,
and a one-rank NCCL group), times each kernel against its plain version
with CUDA events, and prints one JSON line of kernel results, the card's
name and power limit, and last, one JSON line {"ok": true, "device":
{...}}. Any failed phase raises, and the script exits nonzero with no
result line. Neither it nor its worker processes import jax or anything
of libflagstats_tpu.

Each ported path is driven with the launch counts set to 0 just before
it and read just after: phase 4 (a-d) the in-memory entry points, phase
4 (e, f) the streaming device path, phase 4g the word-space impl, phase
4h the data-parallel path (its workers report their own counts).
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import libflagstats_tpu_torch as L
import libflagstats_tpu_torch.parallel.multihost as MH
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.bench.profiling import SectionTimer
from libflagstats_tpu_torch.config import CONFIG
from libflagstats_tpu_torch.datasets import na12878_report_values, synth_na12878
from libflagstats_tpu_torch.io import codec as C
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.io.stream import StreamCheckpoint
from libflagstats_tpu_torch.ops import bitslice as B
from libflagstats_tpu_torch.ops import cuda_build
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import words_kernels as W
from libflagstats_tpu_torch.ops.torch_ops import assemble_counters
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.parallel import flagstat_sharded

WORDS_64MI = 64 << 20
GW = K.GROUP_WORDS
SOURCE = "libflagstats_tpu_torch/ops/csrc/flagstat_kernels.cu"
PRE_SOURCE = "libflagstats_tpu_torch/ops/csrc/flagstat_pre_kernels.cu"
WORDS_SOURCE = "libflagstats_tpu_torch/ops/csrc/flagstat_words_kernels.cu"
REPLACES = "libflagstats_tpu/ops/pallas_kernels.py:403"
WORDS_REPLACES = "libflagstats_tpu/ops/pallas_kernels.py:928"
#: the H100 SXM's nominal device-memory rate (NVIDIA's data sheet): the
#: kernels' bound is the bytes they must move over it
HBM_BYTES_PER_S = 3.35e12
REPO = os.path.dirname(os.path.abspath(__file__))
#: K2's layouts: (name, report, packed)
PRE_LAYOUTS = (("full 32 rows", False, False), ("report 32 rows", True, False),
               ("full 24 rows", False, True), ("report 20 rows", True, True))
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


def check_host_library(build_seconds: float) -> None:
    """Phase 2b: the native host library built, and its packed transpose
    is byte-identical to the numpy spec."""
    if native_lib.load() is None:
        raise RuntimeError(f"the native host library did not build:\n{native_lib.BUILD_ERROR}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()[0]
    header = ("the system <zstd.h>" if native_lib.ZSTD_ROUTE == "system"
              else "libflagstats_tpu_torch/io/csrc/compat/zstd.h, -l:libzstd.so.1")
    print(f"host library built in {build_seconds:.2f} s by {gxx}; zstd: "
          f"{native_lib.ZSTD_ROUTE} ({header})")
    sizes = (1, 65_537, 8 * GW - 4_321)
    for n in sizes:
        x = generate_flags(n, seed=n, full_range=True)
        full = B.pretranspose_host_np(x)
        assert np.array_equal(B.pretranspose_host(x), full), n
        for report in (False, True):
            rows = K.packed_rows_for(report)
            assert np.array_equal(B.pretranspose_host_packed(x, rows),
                                  full[:, list(rows)]), (n, report)
    print(f"native bit transpose (32 rows, packed 24 and 20) = pretranspose_host_np "
          f"byte for byte at {sizes} words")


def check_pre_kernel(max_err: dict) -> None:
    """Phase 3b: K2 = plain = host oracle, exactly, in every layout."""
    wave = max(K.pre_wave_groups(r, p) for _, r, p in PRE_LAYOUTS)
    counts = [0, 1, 2, 7, 8, 9, 129, wave + 1]
    kinds = ["flags<4096", "full16bit", "all 0xFFFF", "all 0x0FFF", "all zero"]
    print(f"K2: one wave of blocks covers {wave} groups; largest count {counts[-1]}")
    cases = 0
    for g in counts:
        n = max(g * GW - 777, 0)   # a ragged last group: zero words pad it
        for kind in kinds:
            x = make_words(kind, n)
            ref = flagstat_numpy(x).astype(np.int64)
            for name, report, packed in PRE_LAYOUTS:
                rows = K.packed_rows_for(report) if packed else tuple(range(32))
                planes = torch.from_numpy(B.pretranspose_host_packed(x, rows)).cuda()
                assert planes.shape[0] == g
                inputs = [("whole", planes, n)]
                if g == 9 and kind == "full16bit":
                    inputs.append(("planes[1:]", planes[1:], n - GW))
                for label, t, nt in inputs:
                    before = dict(K.LAUNCHES)
                    got = K.stream_sums_pre_cuda(t, report, packed)
                    plain = K.stream_sums_pre_plain(t, report, packed)
                    torch.cuda.synchronize()
                    key = "pre_report" if report else "pre"
                    assert K.LAUNCHES[key] == before[key] + (g > 0), (name, g)
                    err = int((got - plain).abs().max())
                    max_err[key] = max(max_err[key], err)
                    where = (name, g, kind, label)
                    assert err == 0, (where, got.tolist(), plain.tolist())
                    c = counters_from_sums(got, "flagstat_report" if report else "flagstat", nt)
                    want = ref if label == "whole" else flagstat_numpy(x[GW:]).astype(np.int64)
                    idx = list(F.REPORT_COUNTERS) if report else list(range(32))
                    assert (c[idx] == want[idx]).all(), (where, c, want)
                    if report:
                        assert (c[REPORT_ZEROS] == 0).all(), where
                    cases += 1
    print(f"K2: {cases} cases ({len(PRE_LAYOUTS)} layouts x group counts {counts} x "
          f"{len(kinds)} kinds, and planes[1:] of a CUDA tensor), kernel = plain = "
          f"oracle exactly (max_abs_err {max_err})")


def check_words_kernel(max_err: dict) -> None:
    """Phase 3c: K6 = plain = host oracle, exactly; and grids forced so
    small that one thread runs far past the packed-half flush interval."""
    lib = cuda_build.load()
    assert lib.lfs_words_flush_bodies() == W.FLUSH_BODIES
    assert lib.lfs_words_block_words() == 256 * W.BODY_WORDS
    wave = W.words_wave_words()
    sizes = [0, 1, 31, 32, 33, 65535, 65536, 65537, 2 * wave + 12345]
    kinds = ["flags<4096", "full16bit", "all 0xFFFF", "all 0x0FFF", "all zero"]
    print(f"K6: one wave of blocks covers {wave} words; largest size {sizes[-1]}")

    def check(xd, n, ref, where, blocks=None):
        before = K.LAUNCHES["words"]
        got = W.stream_sums_words_cuda(xd, blocks=blocks)
        plain = W.stream_sums_words_plain(xd)
        torch.cuda.synchronize()
        assert K.LAUNCHES["words"] == before + (n > 0), where
        err = max(int((g - p).abs().max()) for g, p in zip(got, plain))
        max_err["words"] = max(max_err["words"], err)
        assert err == 0, (where, [g.tolist() for g in got], [p.tolist() for p in plain])
        c = assemble_counters(*got, n).cpu().numpy()
        assert (c == ref).all(), (where, c, ref)

    cases = 0
    for n in sizes:
        for kind in kinds:
            x = make_words(kind, n)
            ref = flagstat_numpy(x).astype(np.int64)
            buf = torch.from_numpy(np.concatenate([np.zeros(1, np.uint16), x])).cuda()
            for offset, xd in (("aligned", buf[1:].clone()), ("odd-offset slice", buf[1:])):
                check(xd, n, ref, (n, kind, offset))
                cases += 1
    # 0x0FFF words set fail-stratum bits in every sixteens word, so every
    # body adds 16 to their packed fields: the worst case for the flush
    forced = [("full16bit", generate_flags(WORDS_64MI, seed=13, full_range=True), (1, 3)),
              ("all 0x0FFF", np.full(4 * WORDS_64MI, 0x0FFF, np.uint16), (1,))]
    for kind, x, grids in forced:
        xd = torch.from_numpy(x).cuda()
        ref = flagstat_numpy(x).astype(np.int64)
        for blocks in grids:
            bodies = -(-x.size // (blocks * lib.lfs_words_block_words()))
            check(xd, x.size, ref, (kind, x.size, f"blocks={blocks}"), blocks)
            print(f"K6 forced grid of {blocks} block(s) on {x.size} {kind} words: "
                  f"{bodies} bodies per thread, {bodies / W.FLUSH_BODIES:.1f}x the "
                  f"flush interval of {W.FLUSH_BODIES}; kernel = plain = oracle")
            cases += 1
        del xd
    print(f"K6: {cases} cases (sizes {sizes} x {len(kinds)} kinds x aligned and "
          f"odd-offset, and the forced grids), kernel = plain = oracle exactly "
          f"(max_abs_err {max_err['words']})")


def launched(before: dict, mode: str) -> None:
    assert K.LAUNCHES[mode] > before[mode], f"{mode} kernel was not launched"
    before.update(K.LAUNCHES)


def drive_main_path() -> dict:
    """Phase 4: the public entry points at full scale."""
    seen = dict(K.LAUNCHES)
    x = generate_flags(WORDS_64MI, seed=7, full_range=True)
    ref = flagstat_numpy(x)
    assert D.auto_impl(x.size) == D.auto_impl(1) == D.auto_impl(0) == "cuda"

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


def check_stream(path, label: str, impl: str, report: bool, card: str, want_report) -> None:
    """One streamed count of the NA12878 file, twice: the report must be
    want_report both times."""
    want = na12878_report_values(1)
    for run in (1, 2):
        timer = SectionTimer()
        t0 = time.perf_counter()
        c = L.flagstat_stream(path, "lz4", impl=impl, report=report, timer=timer)
        wall = time.perf_counter() - t0
        rep = L.counters_to_report(c)
        assert {k: getattr(rep, k)[0] for k in want} == want, (label, rep)
        assert all(getattr(rep, k)[1] == 0 for k in want), (label, rep)
        assert rep == want_report, (label, rep)
        n = int(c[F.FQCFAIL_OFF] + c[16 + F.FQCFAIL_OFF])
        print(f"[{card}] flagstat_stream {label} run {run}: {wall:.3f} s wall, "
              f"{n / wall / 1e9:.3f} Gwords/s; sections:")
        for line in timer.report().splitlines():
            print(f"    {line}")


def drive_stream_path(na_words: np.ndarray, card: str, tmp: str) -> str:
    """Phase 4 (e, f): the streaming device path at full width. Leaves
    the NA12878 LZ4 file in ``tmp`` and returns its path."""
    seen = dict(K.LAUNCHES)
    x = generate_flags(WORDS_64MI, seed=7, full_range=True)
    ref = flagstat_numpy(x)
    c = L.flagstats_u16(x, impl="cuda_pre")
    launched(seen, "pre")
    assert (c == ref).all(), (c, ref)
    print("main path (e): flagstats_u16(impl='cuda_pre') on 64Mi full-range words = oracle")

    path = os.path.join(tmp, "na12878.lz4")
    t0 = time.perf_counter()
    info = C.write_framed(path, na_words, "lz4", level=1)
    print(f"NA12878 as framed LZ4 (level 1): {info.n_blocks} blocks, "
          f"{info.raw_bytes} -> {info.compressed_bytes} bytes (ratio "
          f"{info.raw_bytes / info.compressed_bytes:.3f}), written in "
          f"{time.perf_counter() - t0:.2f} s")
    want_report = L.counters_to_report(L.flagstats_u16(na_words, impl="native"))
    launched_by = (("cuda_pre", "cuda_pre", False, "pre"),
                   ("cuda_pre report=True", "cuda_pre", True, "pre_report"),
                   ("cuda", "cuda", False, "flagstat"),
                   ("default (impl=None)", None, False, "flagstat"),
                   ("native", "native", False, None))
    for label, impl, report, mode in launched_by:
        check_stream(path, label, impl, report, card, want_report)
        if mode:
            launched(seen, mode)
    print("main path (f): flagstat_stream over the NA12878 LZ4 file: cuda_pre, "
          "cuda_pre report=True, cuda, the default (cuda) and native reports = "
          "na12878_report_values(1)")

    # an interrupted, checkpointed run on a truncated copy, resumed on
    # the whole file (blocks of 8 groups = one chunk, so every block
    # boundary can checkpoint)
    path64 = os.path.join(tmp, "x64.lz4")
    C.write_framed(path64, x, "lz4", level=1, block_bytes=2 * 8 * GW)
    part = os.path.join(tmp, "part.lz4")
    with open(part, "wb") as f:
        for raw_len, payload in list(C.iter_framed(path64))[:72]:
            f.write(struct.pack("<ii", raw_len, len(payload)))
            f.write(payload)
    ck_path = os.path.join(tmp, "ck.npz")
    L.flagstat_stream(part, "lz4", impl="cuda_pre", chunk_words=8 * GW,
                      checkpoint=StreamCheckpoint(ck_path, every_blocks=16))
    ck = StreamCheckpoint(ck_path, every_blocks=16)
    assert ck.kind == "sums" and ck.block_index == 64 and ck.n_words == 64 * 8 * GW, \
        (ck.kind, ck.block_index, ck.n_words)
    got = L.flagstat_stream(path64, "lz4", impl="cuda_pre", chunk_words=8 * GW,
                            checkpoint=ck)
    launched(seen, "pre")
    assert (got == ref).all(), (got, ref)
    print("main path (f): checkpoint after 64 of 72 blocks of a truncated 64Mi "
          "file, resumed on all 128 blocks = oracle")
    for name in (path64, part, ck_path):
        os.remove(name)
    return path


def check_na12878(c: np.ndarray, want: np.ndarray, label: str, report: bool = False) -> None:
    """Counters of the NA12878 column: all 32 (or the report counters,
    the rest 0) equal ``want``, and the report is na12878_report_values(1)."""
    idx = list(F.REPORT_COUNTERS) if report else list(range(32))
    assert (c[idx] == want[idx]).all(), (label, c, want)
    if report:
        assert (c[REPORT_ZEROS] == 0).all(), (label, c)
    rep = L.counters_to_report(c)
    expected = na12878_report_values(1)
    assert {k: getattr(rep, k)[0] for k in expected} == expected, (label, rep)
    assert all(getattr(rep, k)[1] == 0 for k in expected), (label, rep)


def drive_words_path(na_words: np.ndarray) -> None:
    """Phase 4g: the word-space impl through the public entry point."""
    seen = dict(K.LAUNCHES)
    x = generate_flags(WORDS_64MI, seed=7, full_range=True)
    assert (L.flagstats_u16(x, impl="cuda_words") == flagstat_numpy(x)).all()
    launched(seen, "words")
    want = L.flagstats_u16(na_words, impl="native")
    t0 = time.perf_counter()
    c = L.flagstats_u16(na_words, impl="cuda_words")
    wall = time.perf_counter() - t0
    launched(seen, "words")
    check_na12878(c, want, "cuda_words")
    print(f"main path (g): flagstats_u16(impl='cuda_words') on 64Mi full-range words = "
          f"oracle; on NA12878 report = na12878_report_values(1) (host wall incl. "
          f"H2D {wall:.3f} s)")


#: one rank of the two-process leg: a gloo group through a file://
#: rendezvous, both ranks on cuda:0; prints one JSON line
MULTIHOST_WORKER = r'''
import json, sys, time
import torch.distributed as dist
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.parallel import multihost as M

rdv, rank, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
M.initialize(init_method="file://" + rdv, world_size=2, rank=rank, backend="gloo")
legs = {}
for impl in ("cuda", "cuda_words"):
    dist.barrier()
    t0 = time.perf_counter()
    c = M.flagstat_multihost_file(path, "lz4", impl=impl)
    legs[impl] = {"counters": c.tolist(), "wall_s": time.perf_counter() - t0}
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "libflagstats_tpu"))
assert not bad, bad
dist.destroy_process_group()
print(json.dumps({"rank": rank, "legs": legs, "launches": K.LAUNCHES}))
'''

#: what NCCL does with two ranks on one card (gloo's reason to be here)
NCCL_SAME_CARD_PROBE = r'''
import datetime, sys, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + sys.argv[1], world_size=2,
                        rank=int(sys.argv[2]), timeout=datetime.timedelta(seconds=60))
t = torch.ones(1, device="cuda")
dist.all_reduce(t)
torch.cuda.synchronize()
print("all_reduce ->", t.item())
dist.destroy_process_group()
'''


def run_ranks(code: str, rdv: str, args: tuple = (), timeout: int = 300) -> list:
    """Two processes of ``code`` with arguments (rdv, rank, *args), pipes
    drained at once -> [(returncode, stdout, stderr)] per rank. Kills
    both on a timeout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", code, rdv, str(rank), *args],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    try:
        with cf.ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(p.communicate, timeout=timeout) for p in procs]
            outs = [f.result() for f in futs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def drive_parallel_path(na_words: np.ndarray, na_path: str, tmp: str, card: str) -> dict:
    """Phase 4h: the data-parallel path at full width. Returns the
    launches its worker processes counted."""
    seen = dict(K.LAUNCHES)
    want = L.flagstats_u16(na_words, impl="native")

    # (i) two shards on one card: the split and the merge
    for impl, report, mode in (("cuda", False, "flagstat"), ("cuda_pre", False, "pre"),
                               ("cuda_words", False, "words"),
                               ("cuda", True, "flagstat_report")):
        t0 = time.perf_counter()
        c = flagstat_sharded(na_words, devices=["cuda:0", "cuda:0"], impl=impl, report=report)
        wall = time.perf_counter() - t0
        launched(seen, mode)
        check_na12878(c, want, f"sharded {impl} report={report}", report)
        print(f"[{card}] main path (h-i): flagstat_sharded(NA12878, 2 shards on cuda:0, "
              f"impl={impl!r}, report={report}) = na12878_report_values(1); host wall "
              f"incl. H2D {wall:.3f} s")

    # (ii) two processes over the LZ4 file, gloo, both ranks on cuda:0
    t0 = time.perf_counter()
    ranks = run_ranks(MULTIHOST_WORKER, os.path.join(tmp, "rdv_gloo"), (na_path,))
    wall = time.perf_counter() - t0
    workers = dict.fromkeys(K.LAUNCHES, 0)
    for rank, (rc, out, err) in enumerate(ranks):
        assert rc == 0, f"multihost worker {rank} failed (rc {rc}):\n{err[-4000:]}"
        res = json.loads(out.strip().splitlines()[-1])
        for impl, leg in res["legs"].items():
            check_na12878(np.array(leg["counters"], np.uint64), want, f"rank {rank} {impl}")
            print(f"[{card}] main path (h-ii): rank {rank} of 2 (gloo, cuda:0) "
                  f"flagstat_multihost_file(NA12878 LZ4, impl={impl!r}) = "
                  f"na12878_report_values(1); {leg['wall_s']:.3f} s")
        for mode, n in res["launches"].items():
            workers[mode] += n
    assert workers["flagstat"] > 0 and workers["words"] > 0, workers
    print(f"two-process leg: {wall:.2f} s wall for both workers, start-up included; "
          f"worker launches {workers}")
    ranks = run_ranks(NCCL_SAME_CARD_PROBE, os.path.join(tmp, "rdv_nccl"), timeout=180)
    for rank, (rc, out, err) in enumerate(ranks):
        last = [line for line in (out + err).splitlines() if "Duplicate GPU" in line
                or "all_reduce" in line][-1:]
        print(f"NCCL probe, two ranks on cuda:0, rank {rank}: rc {rc}; {last}")

    # (iii) a one-rank NCCL group: the all_reduce runs on the card
    x = generate_flags(WORDS_64MI, seed=7, full_range=True)
    ref = flagstat_numpy(x)
    MH.initialize(init_method="file://" + os.path.join(tmp, "rdv_one"), world_size=1,
                  rank=0, backend="nccl")
    try:
        for impl, mode in (("cuda", "flagstat"), ("cuda_words", "words")):
            c = MH.flagstat_multihost(x, impl=impl)
            launched(seen, mode)
            assert (c == ref).all(), (impl, c, ref)
    finally:
        torch.distributed.destroy_process_group()
    print("main path (h-iii): flagstat_multihost(64Mi words) in a one-rank NCCL group, "
          "impl cuda and cuda_words = oracle")
    return workers


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
    """Phases 5 and 5c: K1's modes and K6 against their plain versions,
    CUDA events, median of runs."""
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
            print(f"{label} {mode} bound: {bound_ms(2 * n, K.N_STREAMS[mode]):.4f} ms")
        ms = median_ms(lambda: W.stream_sums_words_cuda(x), 7, 10)
        plain_ms = median_ms(lambda: W.stream_sums_words_plain(x), 5, 1)
        times[(label, "words")] = (ms, plain_ms)
        for name, t in (("kernel", ms), ("plain", plain_ms)):
            print(f"[{card}] {label} K6 words {name}: {t:.4f} ms, {n / t / 1e6:.4g} "
                  f"Gwords/s, {2 * n / t / 1e6:.1f} GB/s read (K1 flagstat "
                  f"{times[(label, 'flagstat')][0]:.4f} ms)")
        print(f"{label} K6 words bound: {bound_ms(2 * n, 2 * W.BITS):.4f} ms")
    return times


def bound_ms(in_bytes: int, n_out: int) -> float:
    """The least time for a kernel: its input read once and its int64
    outputs written once at the nominal device-memory rate."""
    return (in_bytes + 8 * n_out) / HBM_BYTES_PER_S * 1e3


def time_pre_kernel(na_words: np.ndarray, card: str) -> dict:
    """Phase 5b: K2 against its plain version on packed tiles, CUDA
    events, median of runs; and the pinned copy of one stream chunk."""
    times = {}
    x64 = generate_flags(WORDS_64MI, seed=11, full_range=True)
    for label, words in (("64Mi", x64), ("NA12878", na_words)):
        for report in (False, True):
            t = torch.from_numpy(B.pretranspose_host_packed(
                words, K.packed_rows_for(report))).cuda()
            nbytes = t.numel() * 4
            ms = median_ms(lambda: K.stream_sums_pre_cuda(t, report, True), 7, 10)
            plain_ms = median_ms(lambda: K.stream_sums_pre_plain(t, report, True), 5, 1)
            times[(label, report)] = (ms, plain_ms)
            for name, v in (("kernel", ms), ("plain", plain_ms)):
                print(f"[{card}] {label} K2 {'report' if report else 'flagstat'} "
                      f"{t.shape[1]} rows x {t.shape[0]} groups {name}: {v:.4f} ms, "
                      f"{words.size / v / 1e6:.4g} Gwords/s, {nbytes / v / 1e6:.1f} GB/s read")
            n_out = K.N_STREAMS["flagstat_report" if report else "flagstat"]
            print(f"{label} K2 {t.shape[1]} rows bound: {bound_ms(nbytes, n_out):.4f} ms")
            del t
    # for information: what one default stream chunk costs to copy
    chunk = CONFIG.stream_chunk_words
    for name, shape, dtype in (("packed planes (24 rows)", (chunk // GW, 24, 8, 128), torch.int32),
                               ("raw words", (chunk,), torch.int16)):
        host = torch.zeros(shape, dtype=dtype, pin_memory=True)
        dev = torch.empty(shape, dtype=dtype, device="cuda")
        ms = median_ms(lambda: dev.copy_(host, non_blocking=True), 7, 5)
        nbytes = host.numel() * host.element_size()
        print(f"[{card}] pinned H2D of one {chunk}-word stream chunk as {name}: "
              f"{nbytes} bytes, {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch sees none")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    def timed_host_build():
        t0 = time.perf_counter()
        native_lib.load()
        return time.perf_counter() - t0

    # the host library (g++) builds while nvcc builds the kernels
    with cf.ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(timed_host_build)
        t0 = time.perf_counter()
        path = cuda_build.build()
        cuda_build.load()
        print(f"built {path.name} in {time.perf_counter() - t0:.2f} s")
        host_seconds = host_build.result()
    for line in cuda_build.BUILD_LOG.splitlines():
        if line.endswith(".cu:") or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    check_host_library(host_seconds)

    max_err = dict.fromkeys(K.LAUNCHES, 0)
    check_kernels(max_err)
    check_pre_kernel(max_err)
    check_words_kernel(max_err)

    for mode in K.LAUNCHES:
        K.LAUNCHES[mode] = 0
    na_words = drive_main_path()
    launches = dict(K.LAUNCHES)
    print(f"main-path launches (phase 4 a-d): {launches}")
    assert all(launches[m] > 0 for m in K.MODES), launches

    with tempfile.TemporaryDirectory() as tmp:
        for mode in K.LAUNCHES:
            K.LAUNCHES[mode] = 0
        na_path = drive_stream_path(na_words, card, tmp)
        stream_launches = dict(K.LAUNCHES)
        print(f"streaming-path launches (phase 4 e-f): {stream_launches}")
        assert all(stream_launches[m] > 0 for m in K.PRE_MODES), stream_launches

        for mode in K.LAUNCHES:
            K.LAUNCHES[mode] = 0
        drive_words_path(na_words)
        print(f"word-space launches (phase 4g): {dict(K.LAUNCHES)}")
        assert K.LAUNCHES["words"] > 0

        for mode in K.LAUNCHES:
            K.LAUNCHES[mode] = 0
        workers = drive_parallel_path(na_words, na_path, tmp, card)
        parallel_launches = {m: K.LAUNCHES[m] + workers[m] for m in K.LAUNCHES}
        print(f"data-parallel launches (phase 4h): this process {dict(K.LAUNCHES)}, "
              f"with its workers' {parallel_launches}")
        assert all(K.LAUNCHES[m] > 0 for m in ("flagstat", "flagstat_report", "pre",
                                               "words")), K.LAUNCHES

    times = time_kernels(na_words, card)
    pre_times = time_pre_kernel(na_words, card)
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
        "bound_ms": bound_ms(2 * WORDS_64MI, K.N_STREAMS[mode]),
        "bound_by": "bytes",
        "library_ms": None,
    } for mode in K.MODES]
    kernels += [{
        "name": f"stream_sums_pre_kernel<{'report' if report else 'flagstat'},"
                f"{len(K.packed_rows_for(report))}>",
        "route": "cuda",
        "source": PRE_SOURCE,
        "replaces": REPLACES,
        "launches": stream_launches[key],
        "max_abs_err": max_err[key],
        "ms": pre_times[("64Mi", report)][0],
        "plain_ms": pre_times[("64Mi", report)][1],
        "bound_ms": bound_ms(WORDS_64MI // GW * len(K.packed_rows_for(report)) * 4096,
                             K.N_STREAMS["flagstat_report" if report else "flagstat"]),
        "bound_by": "bytes",
        "library_ms": None,
    } for key, report in zip(K.PRE_MODES, (False, True))]
    kernels.append({
        "name": "stream_sums_words_kernel",
        "route": "cuda",
        "source": WORDS_SOURCE,
        "replaces": WORDS_REPLACES,
        "launches": parallel_launches["words"],
        "max_abs_err": max_err["words"],
        "ms": times[("64Mi", "words")][0],
        "plain_ms": times[("64Mi", "words")][1],
        "bound_ms": bound_ms(2 * WORDS_64MI, 2 * W.BITS),
        "bound_by": "bytes",
        "library_ms": None,
    })
    print(json.dumps({"kernels": kernels}))
    print(card)  # as nvidia-smi --query-gpu=name,power.limit prints it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

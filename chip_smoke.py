#!/usr/bin/env python3
"""End-to-end check of libflagstats_tpu_torch on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

or, for a quicker look at some phases only (each phase makes what it
needs that an earlier phase would have made; no kernel JSON line then):

    python3 chip_smoke.py --phases 3c,5c

It builds the CUDA kernels from ops/csrc/ (into build/torch_kernels/)
and the native host library (into build/torch_host/), holds every
kernel against its plain torch version and the host oracles at edge
sizes, drives the public entry points at full scale (64Mi full-range
words, the 824,541,892-word synthetic NA12878 column, and that column
written as a framed LZ4 file of ~0.83 GB in a temporary directory and
streamed back through flagstat_stream, whose device impls decode runs
of whole frames straight into pinned slots (each impl twice with its
SectionTimer table, and the cuda impl once more at 4Mi and 64Mi words
a run beside the 16Mi default, and with one and two decode calls in
flight beside the default four), then counted by the data-parallel path:
two shards on the card, two gloo worker processes over the file, each
leg's wall a rank beside its native twin's, and a one-rank NCCL group), times each kernel against its plain version
with CUDA events, and prints one JSON line of kernel results, the card's
name and power limit, and last, one JSON line {"ok": true, "device":
{...}}. Any failed phase raises, and the script exits nonzero with no
result line. Neither it nor its worker processes import jax or anything
of libflagstats_tpu.

Each ported path is driven with the launch counts set to 0 just before
it and read just after: phase 4 (a-d) the in-memory entry points, phase
4 (e, f) the streaming device path, phase 4g the word-space impl, phase
4h the data-parallel path (its workers report their own counts), phase
4i the measurement path (the `kernels`, `instrumented` and `inmemory`
subcommands, the stage decomposition and the scaling sweep), phase 4k
the container path, phase 4l CRAM, the container legs and na12878_run,
phase 4m the last tools and the entry points. Phase 3d
holds the read roofline (K4) and the three stage probes (K7) against
their plain versions and host references; phase 5d times them. Phase 4j
drives the tuning tools at full width (packed_probe, kernel_sweep,
crossover_sweep, pipeline_balance), the set-algebra functions on the
NA12878 column seen as a bitmap, and one profiler trace; phase 3e holds
the fold kernel (K8) and the set-algebra kernel (K9) against their plain
versions and numpy, and phase 5e times them. Phase 3c holds the
word-space kernel (K6) against its plain version, with grids forced far
past its packed-half flush interval; phase 5c times it on three word
distributions at 64Mi and on the NA12878 column, beside K1 and K4.
Phase 4k drives the container path: it writes a minimal-payload BAM of
the NA12878 column's first 103,067,736 words, a realistic-payload BAM, a
plain SAM and a BGZF SAM of 2^22 words with the port's writers (depth
cut for run time only), counts each and the NA12878 LZ4 file through
flagstat_file on the card (the native reader, then K1), by the fused
host walk and, for the BAMs, by K2 and K6, all against the oracle, and
runs the seven host subcommands of the CLI. Phase 4l drives the rest of
the container path: it writes the same 1/8 of the column as a GZIP CRAM
and 2^22 words as a rANS CRAM with the port's writer (depth cut for run
time only), counts each through flagstat_file on the card (K1), by the
fused host walker, K2 and K6 against the oracle, sums the rANS file's
container ranges, runs the three container legs of multihost (BAM,
BGZF SAM, CRAM) over two gloo worker processes, each on the card (each
rank's column read by the range column readers, then K1) and by the
fused host walkers, and runs na12878_run at 1/8 scale through the CRAM
container and the framed stream. Phase 4m
drives the last tools through their main(): stress at its defaults (K1,
K3, K2 and K6 on random ragged sizes), codegen, alignment_study,
codec_sweep_na12878 at 1/128 of NA12878, multihost_scaling over the
NA12878 LZ4 file and 4k's realistic BAM and BGZF SAM, instrumented's
perf_native block, and graft_entry's entry() and dryrun_multichip(4) on
the card. Phase 4n runs the framed-file leg of multihost in two gloo
worker processes on the card with a corrupt payload in rank 1's range,
through cuda_words and native: rank 1 raises its own error, rank 0 one
that names rank 1, both within seconds. Phase 5f runs the torch_matmul
pospopcnt tier (a torch._int_mm GEMM, not a kernel of the port) at 64Mi
words and on the NA12878 column against K5 and the host count, times it
beside K5 and prints its rows as a JSON line of their own. Every phase
prints what it took, the kernel checks each of 3-3e too, and the run
prints its own seconds before the result lines.
The host oracle of a large column runs in pieces on a thread pool, and
that of one repeated word as its counters times the length (exact).
Phases 4a-d and 4h hold every call on a host column to the staging
rings (ops/staging.py): as many pieces shipped as STAGE_WORDS cuts,
one kernel launch a piece; they print the one-shot walls at 64Mi and on
NA12878 beside impl="native", the ring's first allocation and the
sharded walls. Phase 4s runs only when named: the staging's
shake-downs (the host copy and DMA rates apart, the piece size, the
copy, the transpose threads, cudaHostRegister of the caller's column).
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import glob
import io
import json
import os
import re
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
from libflagstats_tpu_torch import cli
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.bench import instrumented, profiling
from libflagstats_tpu_torch.bench.profiling import SectionTimer
from libflagstats_tpu_torch.config import CONFIG
from libflagstats_tpu_torch.datasets import na12878_report_values, synth_na12878
from libflagstats_tpu_torch.io import bamio, cramio, samio
from libflagstats_tpu_torch.io import codec as C
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.io import stream as S
from libflagstats_tpu_torch.io.stream import StreamCheckpoint
from libflagstats_tpu_torch.ops import bitslice as B
from libflagstats_tpu_torch.ops import cuda_build
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import probe_kernels as P
from libflagstats_tpu_torch.ops import setalgebra as SA
from libflagstats_tpu_torch.ops import staging as ST
from libflagstats_tpu_torch.ops import torch_ops as T
from libflagstats_tpu_torch.ops import words_kernels as W
from libflagstats_tpu_torch.ops.torch_ops import assemble_counters
from libflagstats_tpu_torch.parallel.sharded import shard_bounds
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch import graft_entry
from libflagstats_tpu_torch.tools import (alignment_study, codec_sweep_na12878, codegen,
                                          crossover_sweep, kernel_sweep, multihost_scaling,
                                          na12878_run, packed_probe, pipeline_balance,
                                          stage_decomposition, stress)

WORDS_64MI = 64 << 20
GW = K.GROUP_WORDS
SOURCE = "libflagstats_tpu_torch/ops/csrc/flagstat_kernels.cu"
PRE_SOURCE = "libflagstats_tpu_torch/ops/csrc/flagstat_pre_kernels.cu"
WORDS_SOURCE = "libflagstats_tpu_torch/ops/csrc/flagstat_words_kernels.cu"
PROBE_SOURCE = "libflagstats_tpu_torch/ops/csrc/flagstat_probe_kernels.cu"
SETOP_SOURCE = "libflagstats_tpu_torch/ops/csrc/setalgebra_kernels.cu"
#: the fold's three cases (tools/packed_probe.py): name, packed tiles, rows
FOLD_CASES = (("full32", False, None), ("sub24", False, tuple(sorted(B.NEEDED_ROWS))),
              ("pack24", True, None))
SETOPS = {"intersect": np.bitwise_and, "union": np.bitwise_or,
          "diff": lambda a, b: a & ~b, "popcnt": lambda a, b: a}
#: the probe kernels, their launch counters and the TPU kernels they replace
PROBE_KERNELS = (("read_xor_kernel", "read_xor", "libflagstats_tpu/ops/pallas_kernels.py:605"),
                 ("stream_sums_raw_kernel", "raw", "libflagstats_tpu/ops/pallas_kernels.py:403"),
                 ("transpose_xor_kernel", "transpose_xor",
                  "libflagstats_tpu/ops/pallas_kernels.py:723"),
                 ("transform_xor_kernel", "transform_xor",
                  "libflagstats_tpu/ops/pallas_kernels.py:790"))
REPLACES = "libflagstats_tpu/ops/pallas_kernels.py:403"
WORDS_REPLACES = "libflagstats_tpu/ops/pallas_kernels.py:928"
#: the H100 SXM's nominal device-memory rate (NVIDIA's data sheet): the
#: kernels' bound is the bytes they must move over it
HBM_BYTES_PER_S = 3.35e12
#: its 32-bit integer rates per class of operation (ops/probe_kernels
#: PROBE_OPS): the CUDA C++ Programming Guide's throughput table for
#: compute capability 9.0 (64 logic, add or shift and 16 __popc results
#: per clock per SM) times 132 SMs at the 1.98 GHz boost clock
INT_OPS_PER_S = {"alu": 64 * 132 * 1.98e9, "popc": 16 * 132 * 1.98e9}
REPO = os.path.dirname(os.path.abspath(__file__))
#: K2's layouts: (name, report, packed)
PRE_LAYOUTS = (("full 32 rows", False, False), ("report 32 rows", True, False),
               ("full 24 rows", False, True), ("report 20 rows", True, True))
REPORT_ZEROS = [1, 3, 4, 5, 17, 19, 20, 21]
NA12878_SKIP = [F.FREVERSE_OFF, F.FMREVERSE_OFF, 16 + F.FREVERSE_OFF, 16 + F.FMREVERSE_OFF]
#: the phases, in the order they run: 3-3e kernel checks, 4a (a-d) the
#: in-memory entry points, 4e (e-f) streaming, 4g word space, 4h
#: data-parallel, 4i measurement, 4j tools, 4k container files, 4l CRAM
#: files, the container legs and na12878_run, 4m the last tools,
#: perf_native and the entry points, 4n a bad range of the framed-file
#: leg in two ranks, 4o the epilogue kernel, 5-5e kernel times, 5f the
#: torch_matmul pospopcnt tier
PHASES = ("3", "3b", "3c", "3d", "3e", "4a", "4e", "4g", "4h", "4i", "4j", "4k", "4l", "4m",
          "4n", "4o", "5", "5b", "5c", "5d", "5e", "5f")
#: phases that run only when named: 4s, the staging's shake-downs (the
#: piece size, the host copy, cudaHostRegister of the caller's column)
SHAKEDOWNS = ("4s",)
#: K6's word distributions of phase 5c at 64Mi: full-range words (a
#: lookup's bank is a word's low 5 bits: ~3-4-way conflicts), real flags
#: below 4096, and one repeated flag (99, NA12878's most common; every
#: lookup a broadcast)
#: phase 4k's container files, cut in depth for run time only: a
#: minimal-payload BAM of the NA12878 column's first 1/8 (the slice
#: pipeline_balance streams) and 2^22-word realistic BAM, plain SAM and
#: BGZF SAM; BAM and BGZF members at deflate level 1
CONTAINER_MIN_BAM_WORDS = 103_067_736
CONTAINER_WORDS = 1 << 22
CONTAINER_LEVEL = 1
#: phase 5f's chunks of the torch_matmul tier, timed at 64Mi beside
#: dispatch.MATMUL_CHUNK's
MATMUL_CHUNKS = (1 << 20, 1 << 24)
#: phase 4o's DEVICE_WORD_CAP: the NA12878 column on the card in three
#: chunks, each one count launch and one epilogue launch
EPILOGUE_CAP = 300_000_007
#: phase 4o's timed one-shot calls on the resident column, for each ending
WALL_CALLS = 300
WORDS_DISTRIBUTIONS = (("full-range", lambda n: generate_flags(n, seed=11, full_range=True)),
                       ("flags<4096", lambda n: generate_flags(n, seed=11, full_range=False)),
                       ("one value", lambda n: np.full(n, 99, np.uint16)))


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def pospopcnt_np(x: np.ndarray) -> np.ndarray:
    x32 = x.astype(np.uint32)
    return np.array([np.count_nonzero((x32 >> k) & 1) for k in range(16)], np.int64)


def pospopcnt_hist(x: np.ndarray) -> np.ndarray:
    """pospopcnt_np by a histogram of the words: one pass over a large
    column, then each of the 65536 values' bits times its count (exact)."""
    hist = np.bincount(x, minlength=1 << 16).astype(np.int64)
    bits = (np.arange(1 << 16)[:, None] >> np.arange(16)) & 1
    return hist @ bits


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
            ref = oracle_counts(x).astype(np.int64)
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


def check_host_library(build_seconds: float, readers_seconds: float,
                       columns_seconds: float) -> None:
    """Phase 2b: the native host library, the readers and the range
    column readers built, and the packed transpose is byte-identical to
    the numpy spec."""
    if native_lib.load() is None:
        raise RuntimeError(f"the native host library did not build:\n{native_lib.BUILD_ERROR}")
    if native_lib.load_readers() is None:
        raise RuntimeError(f"the native readers did not build:\n{native_lib.READERS_BUILD_ERROR}")
    native_lib.columns()   # raises with the compiler's message
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()[0]
    header = ("the system <zstd.h>" if native_lib.ZSTD_ROUTE == "system"
              else "libflagstats_tpu_torch/io/csrc/compat/zstd.h, -l:libzstd.so.1")
    print(f"host library built in {build_seconds:.2f} s by {gxx}; zstd: "
          f"{native_lib.ZSTD_ROUTE} ({header})")
    print(f"readers built in {readers_seconds:.2f} s; zlib: the system <zlib.h>, -lz; "
          f"inflate: {native_lib.DEFLATE_ROUTE}")
    print(f"column readers (flag_columns.cpp, cram_columns.cpp) built in "
          f"{columns_seconds:.2f} s")
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
            ref = oracle_counts(x).astype(np.int64)
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
                    want = ref if label == "whole" else oracle_counts(x[GW:]).astype(np.int64)
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
    assert lib.lfs_words_block_words() == 256 * W.TURN_WORDS
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
            ref = oracle_counts(x).astype(np.int64)
            buf = torch.from_numpy(np.concatenate([np.zeros(1, np.uint16), x])).cuda()
            for offset, xd in (("aligned", buf[1:].clone()), ("odd-offset slice", buf[1:])):
                check(xd, n, ref, (n, kind, offset))
                cases += 1
    # a repeated word fills the packed fields fastest: every lane sets the
    # same bits of one stratum, so each of those fields gains 256 per peel,
    # the most it can (0x0FFF: a QC-fail word, transformed bits 2, 8, 9, 10
    # in the high fields; 0x0DFF: a QC-pass word, bits 2, 8, 10 in the low
    # fields, whose wrap would carry into the fail fields)
    forced = [("full16bit", generate_flags(WORDS_64MI, seed=13, full_range=True), (1, 3)),
              ("all 0x0FFF", np.full(4 * WORDS_64MI, 0x0FFF, np.uint16), (1,)),
              ("all 0x0DFF", np.full(4 * WORDS_64MI, 0x0DFF, np.uint16), (1,))]
    for kind, x, grids in forced:
        xd = torch.from_numpy(x).cuda()
        ref = oracle_counts(x).astype(np.int64)
        for blocks in grids:
            bodies = 2 * -(-x.size // (blocks * lib.lfs_words_block_words()))
            check(xd, x.size, ref, (kind, x.size, f"blocks={blocks}"), blocks)
            print(f"K6 forced grid of {blocks} block(s) on {x.size} {kind} words: "
                  f"{bodies} bodies per thread, {bodies / W.FLUSH_BODIES:.1f}x the "
                  f"flush interval of {W.FLUSH_BODIES}; kernel = plain = oracle")
            cases += 1
        del xd
    print(f"K6: {cases} cases (sizes {sizes} x {len(kinds)} kinds x aligned and "
          f"odd-offset, and the forced grids), kernel = plain = oracle exactly "
          f"(max_abs_err {max_err['words']})")


def check_probe_kernels(max_err: dict) -> None:
    """Phase 3d: K4 and the three K7 probes = plain = host reference,
    exactly: 0 words / groups, one group, ragged tails, two 8-group
    steps and 64Mi words, at repeat 1, 2, 3 and 8."""
    sizes = [0, GW, 5 * GW - 777, 8 * GW - 4_321, 16 * GW, WORDS_64MI]
    cases = dict.fromkeys(K.PROBES, 0)

    def same(key, got, plain, want, where):
        err = int((got - plain).abs().max()) if got.numel() else 0
        max_err[key] = max(max_err[key], err)
        assert err == 0, (key, where, got.tolist(), plain.tolist())
        if key == "raw":
            assert (got.cpu().numpy() == want).all(), (key, where, got.tolist(), want)
        else:
            assert P.digest(got) == want, (key, where, P.digest(got), want)
        cases[key] += 1

    for n in sizes:
        x = generate_flags(n, seed=n + 3, full_range=True)
        buf = torch.from_numpy(np.concatenate([np.zeros(1, np.uint16), x])).cuda()
        planes_host = B.pretranspose_host(x)
        planes = torch.from_numpy(planes_host).cuda()
        raw1 = P.stream_sums_raw_np(pospopcnt_np(x))
        want = P.read_xor_np(x)
        for label, xd in (("aligned", buf[1:].clone()), ("odd-offset slice", buf[1:])):
            same("read_xor", P.read_xor_cuda(xd), P.read_xor_plain(xd), want, (n, label))
        for repeat in (1, 2, 3, 8):
            where = (n, planes.shape[0], repeat)
            same("transpose_xor", P.transpose_xor_cuda(buf[1:], repeat),
                 P.transpose_xor_plain(buf[1:], repeat), P.transpose_xor_np(x, repeat), where)
            same("transform_xor", P.transform_xor_pre_cuda(planes, repeat),
                 P.transform_xor_pre_plain(planes, repeat),
                 P.transform_xor_pre_np(planes_host, repeat), where)
            same("raw", P.stream_sums_raw_cuda(planes, repeat),
                 P.stream_sums_raw_plain(planes, repeat), raw1 * repeat, where)
        torch.cuda.synchronize()
        print(f"phase 3d: {n} words ({planes.shape[0]} groups): K4 (aligned and odd-offset), "
              f"K7a/b/c at repeat 1, 2, 3, 8 = plain = host reference")
    print(f"phase 3d: {cases} cases, kernel = plain = host reference exactly (max_abs_err "
          f"{ {k: max_err[k] for k in K.PROBES} })")


def bit_count(u32: np.ndarray) -> int:
    return int(np.bitwise_count(u32).sum(dtype=np.int64))


def check_fold_and_setop(max_err: dict) -> None:
    """Phase 3e: K8 = plain = numpy fold for the three row sets and an
    empty one; K9 = plain = numpy bit count for the four operations,
    unaligned starts and 2^31 set bits included. Exactly."""
    rng = np.random.default_rng(17)
    needed = sorted(B.NEEDED_ROWS)
    group_counts = [0, 1, 7, 8, 1024, 1031]
    cases = 0
    for g in group_counts:
        host32 = rng.integers(0, 1 << 32, size=(g, 32, 8, 128), dtype=np.uint64).astype(np.uint32)
        host24 = np.ascontiguousarray(host32[:, needed])
        dev = {False: torch.from_numpy(host32.view(np.int32)).cuda(),
               True: torch.from_numpy(host24.view(np.int32)).cuda()}
        for name, packed, rows in FOLD_CASES + (("no row", False, ()),):
            before = K.LAUNCHES["fold_xor"]
            got = P.digest(P.fold_xor_cuda(dev[packed], rows))
            plain = P.digest(P.fold_xor_plain(dev[packed], rows))
            want = P.fold_xor_np(host24 if packed else host32, rows)
            torch.cuda.synchronize()
            assert K.LAUNCHES["fold_xor"] == before + (g > 0 and name != "no row"), (name, g)
            max_err["fold_xor"] = max(max_err["fold_xor"], abs(got - plain), abs(got - want))
            assert got == plain == want, (name, g, got, plain, want)
            cases += 1
    print(f"phase 3e: K8 fold_xor: {cases} cases (full32, sub24, pack24 and no row at group "
          f"counts {group_counts}), kernel = plain = numpy exactly (max_abs_err "
          f"{max_err['fold_xor']})")

    def same(a, b, ha, hb, where):
        for op, f in SETOPS.items():
            second = None if op == "popcnt" else b
            before = K.LAUNCHES["setop"]
            got = int(SA.setop_count_cuda(a, second, op))
            plain = int(SA.setop_count_plain(a, second, op))
            want = bit_count(f(ha, hb))
            assert K.LAUNCHES["setop"] == before + (a.numel() > 0), (where, op)
            max_err["setop"] = max(max_err["setop"], abs(got - plain), abs(got - want))
            assert got == plain == want, (where, op, got, plain, want)

    cases = 0
    lane_counts = [0, 1, 250, 16384, WORDS_64MI // 2]   # 0, 4, 1000, 65536 bytes; 64Mi words
    for n in lane_counts:
        ha = rng.integers(0, 1 << 32, size=n + 3, dtype=np.uint64).astype(np.uint32)
        hb = rng.integers(0, 1 << 32, size=n + 3, dtype=np.uint64).astype(np.uint32)
        a = torch.from_numpy(ha.view(np.int32)).cuda()
        b = torch.from_numpy(hb.view(np.int32)).cuda()
        # starts 16-byte aligned, both 4 bytes off, off by different amounts
        for oa, ob in ((0, 0), (1, 1), (1, 2), (3, 0)):
            same(a[oa:oa + n], b[ob:ob + n], ha[oa:oa + n], hb[ob:ob + n], (n, oa, ob))
            cases += 4
    ones = torch.full((1 << 26,), -1, dtype=torch.int32, device="cuda")
    for op, second, want in (("popcnt", None, 1 << 31), ("union", ones, 1 << 31),
                             ("intersect", ones, 1 << 31), ("diff", ones, 0)):
        got = int(SA.setop_count_cuda(ones, second, op))
        plain = int(SA.setop_count_plain(ones, second, op))
        max_err["setop"] = max(max_err["setop"], abs(got - plain), abs(got - want))
        assert got == plain == want, (op, got, plain, want)
        cases += 1
    print(f"phase 3e: K9 setop_count: {cases} cases (4 operations x lane counts {lane_counts} "
          f"x aligned, 4 bytes off and unequally off starts; 2^26 all-ones lanes = 2^31 set "
          f"bits), kernel = plain = numpy exactly (max_abs_err {max_err['setop']})")


_X64 = {}


def words_64mi() -> tuple[np.ndarray, np.ndarray]:
    """The 64Mi full-range words (seed 7) of phases 4a-4j and their
    counters, made once."""
    if not _X64:
        x = generate_flags(WORDS_64MI, seed=7, full_range=True)
        _X64.update(x=x, ref=oracle_counts(x))
    return _X64["x"], _X64["ref"]


def launched(before: dict, mode: str) -> None:
    assert K.LAUNCHES[mode] > before[mode], f"{mode} kernel was not launched"
    before.update(K.LAUNCHES)


def pieces_of(n: int, granule: int = 8) -> int:
    """Pieces ops/staging.py cuts a host column of n words into."""
    return -(-n // (max(ST.STAGE_WORDS // granule, 1) * granule))


def staged(seen: dict, mode: str, pieces: int, fn):
    """fn() through the staging rings: exactly ``pieces`` pieces shipped,
    and as many launches of ``mode``'s kernel, one a piece."""
    before = ST.STAGED["pieces"]
    out = fn()
    shipped, ran = ST.STAGED["pieces"] - before, K.LAUNCHES[mode] - seen[mode]
    assert shipped == pieces == ran, (mode, shipped, pieces, ran)
    seen.update(K.LAUNCHES)
    return out


def walls_beside_native(fn, native, runs: int = 3) -> tuple[float, float]:
    """Least host walls of fn() and native(), in turns (fn, native, ...),
    the card synchronised before each clock stops."""
    best = [float("inf")] * 2
    for _ in range(runs):
        for k, g in enumerate((fn, native)):
            t0 = time.perf_counter()
            g()
            torch.cuda.synchronize()
            best[k] = min(best[k], time.perf_counter() - t0)
    return best[0], best[1]


def drive_main_path(card: str) -> dict:
    """Phase 4: the public entry points at full scale; every call on a
    host column goes through the staging rings, one K1 launch a piece."""
    seen = dict(K.LAUNCHES)
    x, ref = words_64mi()
    assert D.auto_impl(x.size) == D.auto_impl(1) == D.auto_impl(0) == "cuda"
    n64 = pieces_of(x.size)

    # (a) 64Mi full-range words, from the host and from a device tensor
    c = staged(seen, "flagstat", n64, lambda: L.flagstats_u16(x))
    assert (c == ref).all(), (c, ref)
    ring = ST.ring("cuda:0")
    print(f"[{card}] staging ring of cuda:0: {ST.DEPTH} pinned slots of {ST.STAGE_WORDS} "
          f"words ({ST.DEPTH * ST.STAGE_WORDS * 2} bytes), made by the first call in "
          f"{ring.alloc_seconds * 1e3:.3f} ms")
    xd = torch.from_numpy(x).cuda()
    pieces = ST.STAGED["pieces"]
    assert (L.flagstats_u16(xd) == ref).all()
    # words on the card are counted where they lie: one launch, no piece
    assert ST.STAGED["pieces"] == pieces and K.LAUNCHES["flagstat"] == seen["flagstat"] + 1
    launched(seen, "flagstat")
    r = staged(seen, "flagstat_report", n64, lambda: L.flagstats_u16(x, impl="cuda_report"))
    idx = list(F.REPORT_COUNTERS)
    assert (r[idx] == ref[idx]).all() and (r[REPORT_ZEROS] == 0).all()
    p = staged(seen, "pospopcnt", n64, lambda: L.pospopcnt_u16(x))
    assert (p.astype(np.int64) == pospopcnt_np(x)).all()
    assert (L.pospopcnt_u16(x, impl="native") == p).all()
    d = staged(seen, "flagstat", n64, lambda: L.flagstats(x))
    assert d == L.counters_to_dict(ref, x.size)
    wall, native = walls_beside_native(lambda: L.flagstats_u16(x),
                                       lambda: L.flagstats_u16(x, impl="native"))
    seen.update(K.LAUNCHES)
    print(f"main path (a): flagstats_u16, cuda_report, pospopcnt_u16 (and its native "
          f"impl), flagstats on 64Mi full-range words = oracle, each {n64} pieces and "
          f"{n64} launches")
    print(f"[{card}] one-shot wall, 64Mi words from a host column: flagstats_u16 "
          f"{wall * 1e3:.3f} ms, impl='native' {native * 1e3:.3f} ms (least of 3 each, "
          f"in turns)")

    # (c) out= accumulation over three blocks = one call
    acc = np.zeros(32, dtype=np.uint64)
    for block in np.array_split(x, 3):
        staged(seen, "flagstat", pieces_of(block.size), lambda: L.flagstats_u16(block, out=acc))
    assert (acc == c).all()
    print("main path (c): out= over three blocks = one call")

    # (d) a small DEVICE_WORD_CAP splits the stream into exact sub-calls
    cap = D.DEVICE_WORD_CAP
    D.DEVICE_WORD_CAP = 10_000_003
    try:
        per_chunk = sum(pieces_of(len(part)) for part in D._device_chunks(x))
        chunked = staged(seen, "flagstat", per_chunk, lambda: L.flagstats_u16(x))
        chunked_pos = staged(seen, "pospopcnt", per_chunk, lambda: L.pospopcnt_u16(x))
    finally:
        D.DEVICE_WORD_CAP = cap
    assert (chunked == ref).all() and (chunked_pos == p).all()
    print(f"main path (d): DEVICE_WORD_CAP=10,000,003 "
          f"({-(-x.size // 10_000_000)} chunks, {per_chunk} pieces) = oracle")
    del xd

    # (b) the full synthetic NA12878 column
    t0 = time.perf_counter()
    arr, expected = synth_na12878(1)
    print(f"synth_na12878(1): {arr.size} words, shuffled, "
          f"made on the host in {time.perf_counter() - t0:.1f} s")
    n_na = pieces_of(arr.size)
    c = staged(seen, "flagstat", n_na, lambda: L.flagstats_u16(arr))
    keep = [i for i in range(32) if i not in NA12878_SKIP]
    assert (c[keep] == expected[keep]).all(), (c, expected)
    report = L.counters_to_report(c)
    want = na12878_report_values(1)
    assert {k: getattr(report, k)[0] for k in want} == want, report
    assert all(getattr(report, k)[1] == 0 for k in want), report
    r = staged(seen, "flagstat_report", n_na, lambda: L.flagstats_u16(arr, impl="cuda_report"))
    assert L.counters_to_report(r) == report
    wall, native = walls_beside_native(lambda: L.flagstats_u16(arr),
                                       lambda: L.flagstats_u16(arr, impl="native"))
    seen.update(K.LAUNCHES)
    print(f"main path (b): NA12878 {arr.size} words, report = "
          f"na12878_report_values(1), {n_na} pieces and launches a call")
    print(f"[{card}] one-shot wall, NA12878 from a host column: flagstats_u16 "
          f"{wall:.4f} s, impl='native' {native:.4f} s (least of 3 each, in turns)")
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
        # the device stream decodes whole frames straight into its slots
        assert "chunk_copy" not in timer.totals, (label, timer.totals)
        if impl != "native":
            assert "decode" in timer.totals, (label, timer.totals)


def drive_stream_path(na_words: np.ndarray, card: str, tmp: str) -> str:
    """Phase 4 (e, f): the streaming device path at full width. Leaves
    the NA12878 LZ4 file in ``tmp`` and returns its path."""
    seen = dict(K.LAUNCHES)
    x, ref = words_64mi()
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
    # CONFIG.stream_chunk_words beside its default, and fewer decode
    # calls in flight than stream.DECODE_CALLS: one cuda run each
    calls = S.DECODE_CALLS
    for words, n_calls in ((4 << 20, calls), (64 << 20, calls), (None, 1), (None, 2)):
        S.DECODE_CALLS = n_calls
        try:
            t0 = time.perf_counter()
            c = L.flagstat_stream(path, "lz4", impl="cuda", chunk_words=words)
            wall = time.perf_counter() - t0
        finally:
            S.DECODE_CALLS = calls
        assert L.counters_to_report(c) == want_report, (words, n_calls)
        print(f"[{card}] flagstat_stream cuda chunk_words={words or CONFIG.stream_chunk_words}, "
              f"{n_calls} decode calls in flight (defaults {CONFIG.stream_chunk_words}, "
              f"{calls}): {wall:.3f} s wall")
    launched(seen, "flagstat")

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
    x, ref = words_64mi()
    assert (L.flagstats_u16(x, impl="cuda_words") == ref).all()
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
# the first leg is the worker's first card call; "cuda" again is warm
for label, impl in (("cuda (first call)", "cuda"), ("cuda", "cuda"), ("cuda_pre", "cuda_pre"),
                    ("cuda_words", "cuda_words"), ("native", "native")):
    dist.barrier()
    t0 = time.perf_counter()
    c = M.flagstat_multihost_file(path, "lz4", impl=impl)
    legs[label] = {"counters": c.tolist(), "wall_s": time.perf_counter() - t0}
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


#: one rank of phase 4n: a gloo group with a 60 s timeout, both ranks on
#: cuda:0; rank 1's range of the bad file holds a corrupt payload; prints
#: one JSON line
FAULT_WORKER = r'''
import datetime, json, sys, time
import torch.distributed as dist
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.parallel import multihost as M

rdv, rank, good, bad = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
M.initialize(init_method="file://" + rdv, world_size=2, rank=rank, backend="gloo",
             timeout=datetime.timedelta(seconds=60))
faults = {}
for impl in ("cuda_words", "native"):
    dist.barrier()
    t0 = time.perf_counter()
    try:
        M.flagstat_multihost_file(bad, "lz4", impl=impl)
        error = None
    except (ValueError, RuntimeError) as e:
        error = f"{type(e).__name__}: {e}"
    faults[impl] = {"error": error, "wall_s": time.perf_counter() - t0}
# the group is still in step: the good file, counted on the card
good_counters = M.flagstat_multihost_file(good, "lz4", impl="cuda_words").tolist()
mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "libflagstats_tpu"))
assert not mods, mods
dist.destroy_process_group()
print(json.dumps({"rank": rank, "faults": faults, "good": good_counters,
                  "launches": K.LAUNCHES}))
'''
#: what each rank of phase 4n raises: rank 1 its own decode error, rank 0
#: the agreement's error naming rank 1
FAULT_AGREED = "ValueError: flagstat_multihost_file: the walk failed on rank(s) [1]"


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

    # (i) two shards on one card: the split, the staged pieces of both
    # shards in turn through the card's ring, and the merge
    for impl, report, mode in (("cuda", False, "flagstat"), ("cuda_pre", False, "pre"),
                               ("cuda_words", False, "words"),
                               ("cuda", True, "flagstat_report")):
        granule = GW if impl == "cuda_pre" else 8
        pieces = sum(pieces_of(b - a, granule)
                     for a, b in shard_bounds(na_words.size, 2, impl))
        walls = []
        for _ in range(3 if impl in ("cuda", "cuda_pre") and not report else 1):
            t0 = time.perf_counter()
            c = staged(seen, mode, pieces, lambda: L.flagstat_sharded(
                na_words, devices=["cuda:0", "cuda:0"], impl=impl, report=report))
            walls.append(time.perf_counter() - t0)
        check_na12878(c, want, f"sharded {impl} report={report}", report)
        print(f"[{card}] main path (h-i): flagstat_sharded(NA12878, 2 shards on cuda:0, "
              f"impl={impl!r}, report={report}) = na12878_report_values(1), {pieces} pieces "
              f"and launches a call; host walls " + ", ".join(f"{w:.4f}" for w in walls)
              + " s")

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
              "flagstat_multihost_file(NA12878 LZ4) = na12878_report_values(1) in every "
              "leg; its walls: " + ", ".join(f"{impl} {leg['wall_s']:.3f} s"
                                            for impl, leg in res["legs"].items()))
        for mode, n in res["launches"].items():
            workers[mode] += n
    assert all(workers[m] > 0 for m in ("flagstat", "pre", "words")), workers
    print(f"two-process leg: {wall:.2f} s wall for both workers, start-up included; "
          f"worker launches {workers}")
    ranks = run_ranks(NCCL_SAME_CARD_PROBE, os.path.join(tmp, "rdv_nccl"), timeout=180)
    for rank, (rc, out, err) in enumerate(ranks):
        last = [line for line in (out + err).splitlines() if "Duplicate GPU" in line
                or "all_reduce" in line][-1:]
        print(f"NCCL probe, two ranks on cuda:0, rank {rank}: rc {rc}; {last}")

    # (iii) a one-rank NCCL group: the all_reduce runs on the card
    x, ref = words_64mi()
    MH.initialize(init_method="file://" + os.path.join(tmp, "rdv_one"), world_size=1,
                  rank=0, backend="nccl")
    try:
        for impl, mode in (("cuda", "flagstat"), ("cuda_words", "words")):
            c = staged(seen, mode, pieces_of(x.size), lambda: MH.flagstat_multihost(x, impl=impl))
            assert (c == ref).all(), (impl, c, ref)
    finally:
        torch.distributed.destroy_process_group()
    print("main path (h-iii): flagstat_multihost(64Mi words) in a one-rank NCCL group, "
          f"impl cuda and cuda_words = oracle, {pieces_of(x.size)} staged pieces each")
    return workers


def drive_fault_path(tmp: str, card: str) -> dict:
    """Phase 4n: the framed-file leg of multihost with a corrupt payload
    in rank 1's block range, in two gloo worker processes on the card,
    for ``cuda_words`` (the range's column, then K6) and ``native`` (the
    fused host walker): rank 1 raises its own error, rank 0 one naming
    rank 1, both within seconds, and the group then counts a good file.
    Returns the launches the workers counted."""
    x = generate_flags(CONTAINER_WORDS, seed=41, full_range=True)
    good = os.path.join(tmp, "fault.lz4")
    C.write_framed(good, x, "lz4", level=1, block_bytes=1 << 20)
    frames = list(C.iter_framed(good))
    bad = good + ".bad_payload"
    with open(bad, "wb") as f:
        for k, (raw_len, payload) in enumerate(frames):
            f.write(struct.pack("<ii", raw_len, len(payload)))
            # the last frame lies in rank 1's range of the two
            f.write(b"\xff" * len(payload) if k == len(frames) - 1 else payload)
    own = {"cuda_words": "RuntimeError: framed range decode failed",
           "native": f"ValueError: malformed or undecodable framed stream: {bad}"}
    ref = oracle_counts(x)
    t0 = time.perf_counter()
    ranks = run_ranks(FAULT_WORKER, os.path.join(tmp, "rdv_fault"), (good, bad), timeout=240)
    wall = time.perf_counter() - t0
    workers = dict.fromkeys(K.LAUNCHES, 0)
    for rank, (rc, out, err) in enumerate(ranks):
        assert rc == 0, f"fault worker {rank} failed (rc {rc}):\n{err[-4000:]}"
        res = json.loads(out.strip().splitlines()[-1])
        for impl, fault in res["faults"].items():
            want = own[impl] if rank == 1 else FAULT_AGREED
            assert fault["error"] == want, (rank, impl, fault, want)
            assert fault["wall_s"] < 30, (rank, impl, fault)
        assert (np.array(res["good"], np.uint64) == ref).all(), (rank, res["good"])
        print(f"[{card}] fault path (4n): rank {rank} of 2 (gloo, 60 s group timeout, cuda:0), "
              f"{len(frames)} frames, the last one's payload corrupt: " + "; ".join(
                  f"{impl} raised {f['error']!r} after {f['wall_s']:.3f} s"
                  for impl, f in res["faults"].items())
              + "; then the good file's cuda_words count = oracle")
        for mode, n in res["launches"].items():
            workers[mode] += n
    assert workers["words"] > 0, workers
    print(f"fault path (4n): {wall:.2f} s wall for both workers, start-up included; "
          f"worker launches {workers}")
    return workers


def captured(argv: list, main=cli.main, echo: bool = True) -> tuple[int, list]:
    """main(argv) with its standard output kept and (by default) echoed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().splitlines()
    for line in lines if echo else ():
        print(f"    {line}")
    return rc, lines


def drive_measurement_path() -> dict:
    """Phase 4i: the measurement path: the kernels roster at 64Mi words,
    instrumented and inmemory, the stage decomposition and the scaling
    sweep. Returns the stage decomposition's result."""
    rc, lines = captured(["kernels", "-n", str(WORDS_64MI)])
    assert rc == 0 and not any("MISMATCH" in line for line in lines), lines
    footer = [line for line in lines if line.startswith("[roofline:")]
    assert len(footer) == 1, lines
    kind = footer[0].split("]")[0][len("[roofline:"):]
    assert set(kind.split("+")) <= {"read_xor_cuda", "read_sum"}, kind
    timed = [line.split("\t") for line in lines[1:] if not line.startswith("[roofline")]
    assert len(timed) == 11 and [c[0] for c in timed[-2:]] == ["setop_popcnt",
                                                               "setop_intersect"], timed
    for cols in timed:
        assert float(cols[5].rstrip("!")) <= 1.05, cols
    print(f"main path (i): kernels roster, {len(timed)} timed rows, no MISMATCH, every row "
          f"<= 1.05x the roofline ({kind}, {footer[0].split(chr(9))[4]} GB/s)")
    # at its default size the column (2 MiB) sits in the L2: the roofline
    # is measured over ROOFLINE_MIN_BYTES instead, and every row is priced
    note = io.StringIO()
    with contextlib.redirect_stderr(note):
        rc, lines = captured(["instrumented", "-n", str(1 << 20)])
    print(f"    {note.getvalue().strip()}")
    rows = [line.split("\t") for line in instrumented.rows(lines)]
    assert rc == 0 and all(r[-1] == "ok" and r[-2] != "n/a" for r in rows), lines
    assert len(rows) == 6 and lines[len(rows) + 1] == "", lines   # then the perf block
    assert note.getvalue().endswith(f"over {instrumented.ROOFLINE_MIN_BYTES} bytes\n"), note
    rc, lines = captured(["inmemory"])
    assert rc == 0 and all(line.endswith("OK") for line in lines), lines
    print(f"main path (i): instrumented -n 1048576 (roofline over "
          f"{instrumented.ROOFLINE_MIN_BYTES} bytes, every row priced) and inmemory: "
          f"every row ok")
    stages = stage_decomposition.run()
    for stage in stage_decomposition.STAGES:
        c = stages["compute"][stage]
        # a folded rep loop leaves T(r1) in the read's shadow at any r
        assert c["alu_ms"] is not None and c["alu_ms"] > 0 and not c["r1_still_shadowed"], \
            (stage, c)
    print("main path (i): stage decomposition: alu_ms " + ", ".join(
        f"{s} {stages['compute'][s]['alu_ms']:.4f}" for s in stage_decomposition.STAGES))
    sweep = MH.scaling_sweep(devices=["cuda:0"])
    assert [r["devices"] for r in sweep] == [1] and sweep[0]["words_per_s"] > 0, sweep
    print(f"main path (i): scaling_sweep on cuda:0: {sweep}")
    return stages


def drive_tools_path(na_words: np.ndarray, tmp: str) -> None:
    """Phase 4j: the tuning tools at full width, each through its main();
    the set-algebra functions on the NA12878 column seen as a bitmap;
    one profiler trace of a 64Mi flagstats_u16 call."""
    rc, lines = captured([], packed_probe.main)
    assert rc == 0 and [ln.split("\t")[0] for ln in lines[1:4]] == [c[0] for c in FOLD_CASES], lines
    assert all(ln.endswith("\tOK") for ln in lines[1:4]), lines
    ratios = {ln.split()[1]: float(ln.split()[3]) for ln in lines if ln.startswith("# ")}
    print(f"main path (j): packed_probe at {packed_probe.GROUPS} groups: every case OK; "
          f"time ratios to full32 {ratios}")

    rc, lines = captured([], kernel_sweep.main)
    rows = [ln for ln in lines if ln.startswith("mode=")]
    assert rc == 0 and len(rows) == 7 * len(kernel_sweep.WAVES), lines
    assert all(ln.endswith(", OK") for ln in rows), rows
    print(f"main path (j): kernel_sweep at {kernel_sweep.N_WORDS} words: {len(rows)} rows "
          f"(7 kernel layouts x {kernel_sweep.WAVES} waves), every one OK")

    sizes = ["1024", str(1 << 18), str(WORDS_64MI)]
    for flag in ([], ["--pospopcnt"]):
        rc, lines = captured(flag + sizes, crossover_sweep.main)
        table = [ln.split("\t") for ln in lines if ln[:1].isdigit()]
        assert rc == 0 and [r[0] for r in table] == sizes, lines
        # no nan: every tier ran (pospopcnt_u16 has no cuda_pre or cuda_words)
        timed = 7 if flag else 9
        assert all(float(v) > 0 for r in table for v in r[1:timed]), table
        assert sum(ln.startswith("# suggested") for ln in lines) == 6, lines
    print(f"main path (j): crossover_sweep and --pospopcnt at {sizes} words: every tier timed")

    rc, lines = captured([], pipeline_balance.main)
    legs = [ln for ln in lines if ln.startswith("== ")]
    assert rc == 0 and len(legs) == 5 and all(ln.endswith("check=ok") for ln in legs), lines
    runs = [re.findall(r"\d+\.\d+s", ln.split("the fastest of ")[1].split("(")[0]) for ln in legs]
    assert all(len(r) == pipeline_balance.RUNS for r in runs), legs   # every run printed
    assert sum(ln.startswith("overlap benefit") for ln in lines) == 2, lines
    print(f"main path (j): pipeline_balance at {pipeline_balance.N_WORDS} words: 5 legs of "
          f"{pipeline_balance.RUNS} runs each, every check=ok")

    # the column's 1,649,083,784 bytes as a bitmap, and a seeded second one
    a_host = na_words.view(np.uint32)
    b_host = np.random.default_rng(5).integers(0, 1 << 32, size=a_host.size, dtype=np.uint32)
    a, b = torch.from_numpy(na_words).cuda(), torch.from_numpy(b_host.view(np.int32)).cuda()
    before = K.LAUNCHES["setop"]
    for fn, args_host, args_dev in ((L.popcnt, (a_host,), (a,)),
                                    (L.intersect_count, (a_host, b_host), (a, b)),
                                    (L.union_count, (a_host, b_host), (a, b)),
                                    (L.diff_count, (a_host, b_host), (a, b))):
        want = fn(*args_host, impl="native")
        t0 = time.perf_counter()
        got = fn(*args_dev)
        wall = time.perf_counter() - t0
        assert got == want, (fn.__name__, got, want)
        print(f"main path (j): {fn.__name__} on {a_host.nbytes} bytes per bitmap, on the card: "
              f"{got} = the native host count ({wall * 1e3:.3f} ms host wall, bitmaps resident)")
    assert L.popcnt(na_words) == L.popcnt(a_host, impl="native")   # a host column: copied
    assert K.LAUNCHES["setop"] == before + 5, K.LAUNCHES
    del a, b

    x, ref = words_64mi()
    logdir = os.path.join(tmp, "trace")
    with profiling.trace(logdir):
        c = L.flagstats_u16(x)
        torch.cuda.synchronize()
    files = glob.glob(os.path.join(logdir, "*.trace.json"))
    assert len(files) == 1 and (c == ref).all(), files
    with open(files[0]) as f:
        text = f.read()
    assert "stream_sums_kernel" in text, "the trace does not name K1's kernel"
    print(f"main path (j): profiling.trace around flagstats_u16(64Mi words): "
          f"{os.path.getsize(files[0])} bytes of Chrome trace, names stream_sums_kernel")


def _host_ms(fn, runs: int = 3) -> float:
    """Least host wall of fn() with the card synchronised, in ms."""
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def shake_down_staging(na_words: np.ndarray, card: str) -> None:
    """Phase 4s, only when named: the staging's shake-downs, each count
    held against the oracle. (i) The rates apart: the host copy of 64Mi
    words into pinned memory (torch's copy_ and a thread pool of
    np.copyto), the pinned and the pageable copy to the card. (ii) The
    one-shot wall of flagstats_u16 at 64Mi and on NA12878 at STAGE_WORDS
    1Mi, 4Mi and 16Mi in turns (1, 4, 16, 16, 4, 1), and with the pool's
    copy, each beside impl='native'; cuda_pre and the sharded cuda_pre
    at 2, 4 and as many transpose threads as the process has cores. (iii)
    cudaHostRegister of the caller's column, one pinned copy, one K1
    launch and cudaHostUnregister, against the staged call."""
    x, ref = words_64mi()
    want_na = L.flagstats_u16(na_words, impl="native")
    cols = (("64Mi", x, ref), ("NA12878", na_words, want_na))
    cores = len(os.sched_getaffinity(0))
    print(f"[{card}] (4s) host: os.cpu_count() {os.cpu_count()}, cores this process may "
          f"use {cores}, torch intra-op threads {torch.get_num_threads()}")
    pool = cf.ThreadPoolExecutor(cores)

    def pool_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
        d, s = dst.numpy(), src.numpy()
        step = -(-s.size // cores)
        list(pool.map(lambda a: np.copyto(d[a:a + step], s[a:a + step]), range(0, s.size, step)))

    src = torch.from_numpy(x.view(np.int16))
    pinned = torch.empty(x.size, dtype=torch.int16, pin_memory=True)
    on_card = torch.empty(x.size, dtype=torch.int16, device="cuda")
    mb = x.nbytes / 1e6
    rates = {"host copy_ into pinned": _host_ms(lambda: pinned.copy_(src)),
             f"host pool of {cores} np.copyto into pinned": _host_ms(
                 lambda: pool_copy(pinned, src)),
             "pinned -> card": median_ms(lambda: on_card.copy_(pinned, non_blocking=True),
                                         runs=3, reps=1),
             "pageable -> card": _host_ms(lambda: on_card.copy_(src))}
    print(f"[{card}] (4s-i) rates apart, {x.nbytes} bytes: " + "; ".join(
        f"{k} {v:.3f} ms ({mb / v:.2f} GB/s)" for k, v in rates.items()))
    del pinned, on_card

    orig = ST.STAGE_WORDS, ST._copy_in, ST.TRANSPOSE_THREADS
    turns = [("copy_", w) for w in (1 << 20, 1 << 22, 1 << 24, 1 << 24, 1 << 22, 1 << 20)]
    try:
        for copy_name, words in turns + [("pool", orig[0])]:
            ST._copy_in = pool_copy if copy_name == "pool" else orig[1]
            ST.STAGE_WORDS = words
            for name, col, want in cols:
                assert (L.flagstats_u16(col) == want).all(), (copy_name, words, name)
                wall, native = walls_beside_native(
                    lambda: L.flagstats_u16(col), lambda: L.flagstats_u16(col, impl="native"))
                print(f"[{card}] (4s-ii) host copy {copy_name}, STAGE_WORDS {words}, {name}: "
                      f"flagstats_u16 {wall * 1e3:.3f} ms ({col.nbytes / wall / 1e9:.2f} "
                      f"GB/s), native {native * 1e3:.3f} ms, ratio {wall / native:.3f}; "
                      f"ring made in {ST.ring('cuda:0').alloc_seconds * 1e3:.3f} ms")
        ST.STAGE_WORDS, ST._copy_in = orig[:2]
        for threads in (2, 4, cores, 4, 2):
            ST.TRANSPOSE_THREADS = threads
            for name, col, want in cols:
                assert (L.flagstats_u16(col, impl="cuda_pre") == want).all(), (threads, name)
                ms = _host_ms(lambda: L.flagstats_u16(col, impl="cuda_pre"))
                print(f"[{card}] (4s-ii) cuda_pre, {threads} transpose threads, "
                      f"{name}: {ms:.3f} ms")
            ms = _host_ms(lambda: L.flagstat_sharded(na_words, devices=["cuda:0"] * 2,
                                                     impl="cuda_pre"))
            print(f"[{card}] (4s-ii) flagstat_sharded cuda_pre, 2 shards on cuda:0, "
                  f"{threads} transpose threads, NA12878: {ms:.3f} ms")
    finally:
        ST.STAGE_WORDS, ST._copy_in, ST.TRANSPOSE_THREADS = orig
    for name, col, want in cols:
        assert (L.flagstats_u16(col, impl="cuda_words") == want).all(), name
        ms = _host_ms(lambda: L.flagstats_u16(col, impl="cuda_words"))
        print(f"[{card}] (4s-ii) cuda_words at the default STAGE_WORDS, {name}: {ms:.3f} ms")
    pool.shutdown()

    cudart = torch.cuda.cudart()
    for name, col, want in cols:
        t = {}
        for run in range(3):
            host = col.copy()     # a fresh column each run, as a caller's
            t0 = time.perf_counter()
            rc = cudart.cudaHostRegister(host.ctypes.data, host.nbytes, 0)
            t1 = time.perf_counter()
            assert rc == cudart.cudaError.success, (name, rc)
            words = torch.from_numpy(host.view(np.int16))
            assert words.is_pinned(), name
            sums = K.stream_sums_cuda(words.to("cuda", non_blocking=True), "flagstat")
            got = counters_from_sums(sums, "flagstat", host.size)
            t2 = time.perf_counter()
            assert cudart.cudaHostUnregister(host.ctypes.data) == cudart.cudaError.success
            t3 = time.perf_counter()
            assert (got == want).all(), name
            staged_ms = _host_ms(lambda: L.flagstats_u16(host), runs=1)
            for k, v in (("register", t1 - t0), ("copy+count", t2 - t1),
                         ("unregister", t3 - t2), ("all", t3 - t0)):
                t.setdefault(k, []).append(v * 1e3)
            t.setdefault("staged", []).append(staged_ms)
        print(f"[{card}] (4s-iii) cudaHostRegister of the caller's column, {name}, 3 runs "
              "(ms): " + "; ".join(f"{k} " + ", ".join(f"{v:.3f}" for v in vs)
                                   for k, vs in t.items()))


#: words of one piece of the threaded oracle
ORACLE_PIECE = 1 << 22


def oracle_counts(words: np.ndarray) -> np.ndarray:
    """flagstat_numpy of ``words``, exactly and fast: a column of one
    repeated word gives that word's counters times its length (every
    counter is a sum over words), any other goes in 4Mi-word pieces on
    a thread pool (the oracle is additive over pieces, and numpy
    releases the GIL)."""
    step = ORACLE_PIECE
    if words.size <= step:
        return flagstat_numpy(words)
    if not (words != words[0]).any():
        return flagstat_numpy(words[:1]) * np.uint64(words.size)
    with cf.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        parts = list(pool.map(lambda a: flagstat_numpy(words[a:a + step]),
                              range(0, words.size, step)))
    return np.sum(parts, axis=0, dtype=np.uint64)


def write_bgzf(src: str, dst: str, level: int) -> None:
    """The bytes of ``src`` as BGZF members of 60,000 bytes at ``level``,
    deflated on a thread pool, then the EOF member."""
    data = np.memmap(src, dtype=np.uint8, mode="r")
    offs = range(0, data.size, 60_000)
    with open(dst, "wb") as fh, cf.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        for member in pool.map(lambda o: bamio._bgzf_member(data[o:o + 60_000].tobytes(),
                                                            level=level), offs, chunksize=64):
            fh.write(member)
        fh.write(bamio.BGZF_EOF)


def count_container(label: str, path: str, kind: str, words: np.ndarray, ref: np.ndarray,
                    card: str, impls=(("native", None),), tag: str = "4k") -> dict:
    """Phase 4k or 4l on one file: its kind, its column read by the
    native column route (for a CRAM also by the Python container walk,
    ``read_cram_flags_py``, the route before the container column
    reader), and flagstat_file on the card (impl=None: that route, then
    K1 once a staged piece) and with each of ``impls`` (name, launch counter or None) =
    ``ref`` in all 32 counters; prints the file's host walls and returns
    them."""
    from libflagstats_tpu_torch.io import read_flags_auto, sniff_format

    assert sniff_format(path) == kind, (label, sniff_format(path))
    route = {"bam": bamio, "sam": samio, "cram": cramio}.get(kind)
    t = {}
    t0 = time.perf_counter()
    col = read_flags_auto(path)
    t["read"] = time.perf_counter() - t0
    assert route is None or route.READ_ROUTE == "native", (label, route.READ_ROUTE)
    assert np.array_equal(col, words), label
    seen = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    c = L.flagstats_u16(col)
    t["count"] = time.perf_counter() - t0
    launched(seen, "flagstat")
    assert (c == ref).all(), (label, c, ref)
    del col
    if kind == "cram":
        t0 = time.perf_counter()
        col = cramio.read_cram_flags_py(path)
        t["read_py"] = time.perf_counter() - t0
        assert np.array_equal(col, words), label
        del col
    if route is not None:
        route.READ_ROUTE = None
    t0 = time.perf_counter()
    c = L.flagstat_file(path)
    t["flagstat_file"] = time.perf_counter() - t0
    if route is not None:   # a container: its column, then K1 once a staged piece
        assert route.READ_ROUTE == "native", (label, route.READ_ROUTE)
        assert K.LAUNCHES["flagstat"] == seen["flagstat"] + pieces_of(words.size), \
            (label, K.LAUNCHES, seen)
    launched(seen, "flagstat")
    assert (c == ref).all(), (label, c, ref)
    for impl, mode in impls:
        t0 = time.perf_counter()
        c = L.flagstat_file(path, impl=impl)
        t[impl] = time.perf_counter() - t0
        if mode:
            launched(seen, mode)
        assert (c == ref).all(), (label, impl, c, ref)
    print(f"[{card}] {tag} {label}: {os.path.getsize(path)} bytes, {words.size} words, kind "
          f"{kind}; walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
          + f"; flagstat_file / native = {t['flagstat_file'] / t['native']:.2f}; "
          f"every count = the oracle in all 32 counters")
    return t


def write_realistic_bam(path: str, words: np.ndarray) -> None:
    bamio.write_bam(path, words, level=CONTAINER_LEVEL, payload="realistic",
                    threads=os.cpu_count() or 4)


def write_bgzf_sam(path: str, words: np.ndarray) -> None:
    """A realistic-payload SAM of ``words`` as BGZF members."""
    text = path.removesuffix(".gz")
    samio.write_sam(text, words, payload="realistic")
    write_bgzf(text, path, CONTAINER_LEVEL)
    os.remove(text)


def drive_container_path(na_words: np.ndarray, na_path: str, tmp: str, card: str) -> None:
    """Phase 4k: the container path. Writes a minimal and a realistic
    BAM, a plain and a BGZF SAM with the port's writers, counts each and
    the NA12878 LZ4 file through flagstat_file on the card and by the
    other impls, then drives the host subcommands of the CLI."""
    ncpu = os.cpu_count() or 4
    n_min, n = CONTAINER_MIN_BAM_WORDS, CONTAINER_WORDS
    print(f"4k depth, cut for run time only: minimal BAM {n_min} words (1/8 of NA12878), "
          f"realistic BAM, plain SAM and BGZF SAM {n} words each, BAM and BGZF at deflate "
          f"level {CONTAINER_LEVEL}; the NA12878 LZ4 file whole; decompress d/s on the "
          f"{n}-word LZ4 file that `compress` writes from the realistic BAM")
    print(f"readers: zlib -lz, inflate {native_lib.DEFLATE_ROUTE}")
    bam_impls = (("native", None), ("cuda_pre", "pre"), ("cuda_words", "words"))

    def made(label, write):
        t0 = time.perf_counter()
        write()
        print(f"[{card}] 4k {label}: written in {time.perf_counter() - t0:.3f} s")

    words = na_words[:n_min]
    path = os.path.join(tmp, "min.bam")
    made("minimal BAM", lambda: bamio.write_bam(path, words, level=CONTAINER_LEVEL,
                                                 threads=ncpu))
    t = count_container("minimal BAM", path, "bam", words, oracle_counts(words), card,
                        bam_impls)
    print(f"[{card}] 4k minimal BAM: read / count = {t['read'] / t['count']:.1f}; "
          f"read / native = {t['read'] / t['native']:.2f}")
    os.remove(path)

    words = na_words[:n]
    ref = oracle_counts(words)
    real_bam = os.path.join(tmp, "real.bam")
    made("realistic BAM", lambda: write_realistic_bam(real_bam, words))
    count_container("realistic BAM", real_bam, "bam", words, ref, card, bam_impls)

    path = os.path.join(tmp, "plain.sam")
    made("plain SAM", lambda: samio.write_sam(path, words))
    count_container("plain SAM", path, "sam", words, ref, card)
    os.remove(path)

    path = os.path.join(tmp, "real.sam.gz")
    made("BGZF SAM", lambda: write_bgzf_sam(path, words))
    shards = max(1, min(8, ncpu // 2))
    members = samio.bgzf_member_count(path)
    assert members >= 16 * shards, (members, shards)   # enough for the split
    count_container("BGZF SAM", path, "sam", words, ref, card)
    split = samio._flagstat_bgzf_sam_parallel(path)
    assert split is not None and (split == ref).all(), split
    print(f"[{card}] 4k BGZF SAM: {members} members, the member-range split over "
          f"{shards} ranges = the oracle")

    if na_path is None:
        na_path = os.path.join(tmp, "na12878.lz4")
        made("NA12878 LZ4", lambda: C.write_framed(na_path, na_words, "lz4", level=1))
    t0 = time.perf_counter()
    na_ref = oracle_counts(na_words)
    print(f"[{card}] 4k NA12878 LZ4: flagstat_numpy of {na_words.size} words in "
          f"{time.perf_counter() - t0:.3f} s")
    count_container("NA12878 LZ4", na_path, "framed-lz4", na_words, na_ref, card)
    check_na12878(na_ref, na_ref, "NA12878 LZ4")   # its report is na12878_report_values(1)

    # the host subcommands, as a user runs them
    seen = dict(K.LAUNCHES)
    for path, want in ((real_bam, ref), (na_path, na_ref)):
        rc, lines = captured(["flagstat", path])
        launched(seen, "flagstat")
        assert rc == 0 and lines == L.counters_to_report(want).text().splitlines(), lines
    lz = os.path.join(tmp, "real.lz4")
    assert cli.main(["compress", real_bam, "-o", lz]) == 0
    assert np.array_equal(C.read_framed(lz, "lz4"), words)
    rc, d_lines = captured(["decompress", lz, "--mode", "d", "--stream", "--timers"])
    launched(seen, "flagstat")
    rc_s, s_lines = captured(["decompress", lz, "--mode", "s"], echo=False)
    assert rc == rc_s == 0 and d_lines == s_lines == \
        L.counters_to_report(ref).text().splitlines(), (d_lines, s_lines)
    col = os.path.join(tmp, "real.flags.bin")
    assert cli.main(["bam2flags", real_bam, "-o", col]) == 0
    assert np.array_equal(np.fromfile(col, dtype="<u2"), words)
    rc, text_lines = captured(["generate", str(n), "--seed", "5"], echo=False)
    txt, gen, util = (os.path.join(tmp, name) for name in ("g.txt", "g.bin", "u.bin"))
    with open(txt, "w") as f:
        f.write("\n".join(text_lines) + "\n")
    assert rc == 0 and cli.main(["generate", str(n), "--seed", "5", "--binary", gen]) == 0
    assert cli.main(["utility", "--input", txt, "-o", util]) == 0
    with open(gen, "rb") as f, open(util, "rb") as g:
        assert f.read() == g.read()
    assert np.array_equal(np.fromfile(gen, dtype="<u2"), generate_flags(n, seed=5))
    rc, lines = captured(["codec-sweep", gen, "--lz4-levels", "1", "--zstd-levels", "1"])
    launched(seen, "flagstat")
    assert rc == 0 and [line.split("\t")[:2] for line in lines[1:]] == \
        [["lz4", "fast_a1"], ["zstd", "c1"], ["raw", "-"]], lines
    for name in (lz, col, txt, gen, util):   # phase 4l's legs reuse the BAM and BGZF SAM
        os.remove(name)
    print(f"main path (k): CLI flagstat on the realistic BAM and the NA12878 LZ4 file, "
          f"compress from the BAM read back equal, decompress --mode d --stream = --mode s, "
          f"bam2flags, generate --binary = generate | utility, codec-sweep: all as expected")


#: one rank of phase 4l's two-process container legs: a gloo group
#: through a file:// rendezvous; prints one JSON line
CONTAINER_LEGS_WORKER = r'''
import json, sys, time
import torch.distributed as dist
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.parallel import multihost as M

rdv, rank, runs = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
M.initialize(init_method="file://" + rdv, world_size=2, rank=rank, backend="gloo")
legs = {}
for name, leg, path, kw in runs:
    dist.barrier()
    seen = K.LAUNCHES["flagstat"]
    t0 = time.perf_counter()
    c = getattr(M, "flagstat_multihost_" + leg)(path, **kw)
    legs[name] = {"counters": c.tolist(), "wall_s": time.perf_counter() - t0,
                  "k1_launches": K.LAUNCHES["flagstat"] - seen}
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "libflagstats_tpu"))
assert not bad, bad
dist.destroy_process_group()
print(json.dumps({"rank": rank, "legs": legs}))
'''


def drive_cram_path(na_words: np.ndarray, tmp: str, card: str) -> None:
    """Phase 4l: the rest of the container path. Writes the NA12878
    column's first 1/8 as a GZIP CRAM and 2^22 words as a rANS CRAM with
    the port's writer, counts each through flagstat_file on the card
    (K1), by the fused host walker, K2 and K6, sums the rANS file's
    container ranges, runs the three container legs of multihost over
    two gloo ranks on the card and by the fused walkers, and runs
    na12878_run at 1/8 scale in both modes."""
    n_min, n = CONTAINER_MIN_BAM_WORDS, CONTAINER_WORDS
    print(f"4l depth, cut for run time only: GZIP CRAM {n_min} words (1/8 of NA12878; the "
          f"writer is Python, gzip level 6, threaded over containers), rANS CRAM, realistic "
          f"BAM and BGZF SAM {n} words each; na12878_run at --scale 8")
    impls = (("native", None), ("cuda_pre", "pre"), ("cuda_words", "words"))

    def made(label, write, path):
        t0 = time.perf_counter()
        write()
        print(f"[{card}] 4l {label}: written in {time.perf_counter() - t0:.3f} s, "
              f"{os.path.getsize(path)} bytes")

    words = na_words[:n_min]
    path = os.path.join(tmp, "min.cram")
    made("1/8 NA12878 GZIP CRAM", lambda: cramio.write_cram(path, words), path)
    t = count_container("1/8 NA12878 GZIP CRAM", path, "cram", words, oracle_counts(words),
                        card, impls, tag="4l")
    print(f"[{card}] 4l 1/8 NA12878 GZIP CRAM: read / count = {t['read'] / t['count']:.1f}; "
          f"read / native = {t['read'] / t['native']:.2f}; read_py / read = "
          f"{t['read_py'] / t['read']:.2f}")
    os.remove(path)

    words = na_words[:n]
    ref = oracle_counts(words)
    rans = os.path.join(tmp, "rans.cram")
    made("rANS CRAM", lambda: cramio.write_cram(rans, words, method=cramio.RANS), rans)
    count_container("rANS CRAM", rans, "cram", words, ref, card, impls, tag="4l")
    containers = cramio.data_container_count(rans)
    half = containers // 2
    for impl in (None, "native"):
        seen = dict(K.LAUNCHES)
        parts = [cramio.flagstat_cram_range(rans, a, b, impl=impl)
                 for a, b in ((0, half), (half, containers))]
        if impl is None:
            launched(seen, "flagstat")
            assert cramio.READ_ROUTE == "native", cramio.READ_ROUTE
        assert (parts[0] + parts[1] == ref).all(), (impl, parts)
    print(f"[{card}] 4l rANS CRAM: flagstat_cram_range over containers [0, {half}) + "
          f"[{half}, {containers}) = the oracle, on the card (K1) and by the fused walker")

    # the three container legs over two gloo ranks, on files 4k left or made now
    files = {"bam": os.path.join(tmp, "real.bam"), "bgzf_sam": os.path.join(tmp, "real.sam.gz"),
             "cram": rans}
    for leg, write in (("bam", write_realistic_bam), ("bgzf_sam", write_bgzf_sam)):
        if not os.path.exists(files[leg]):
            made(f"{leg} for the legs", lambda: write(files[leg], words), files[leg])
    t0 = time.perf_counter()
    # each leg on the card route (impl=None: each rank's column, K1) and
    # by the fused host walkers (impl="native"); the first card call of a
    # worker pays its context and module load, so every card leg runs
    # twice and its _warm run is the leg's own time
    runs = [(leg, leg, path, {}) for leg, path in files.items()]
    runs += [(f"{leg}_warm", leg, path, {}) for leg, path in files.items()]
    runs += [(f"{leg}_native", leg, path, {"impl": "native"}) for leg, path in files.items()]
    ranks = run_ranks(CONTAINER_LEGS_WORKER, os.path.join(tmp, "rdv_legs"),
                      (json.dumps(runs),))
    wall = time.perf_counter() - t0
    for rank, (rc, out, err) in enumerate(ranks):
        assert rc == 0, f"container-legs worker {rank} failed (rc {rc}):\n{err[-4000:]}"
        res = json.loads(out.strip().splitlines()[-1])
        assert sorted(res["legs"]) == sorted(r[0] for r in runs), res
        for leg, got in res["legs"].items():
            assert (np.array(got["counters"], np.uint64) == ref).all(), (rank, leg, got)
        # every card leg counts its rank's column on the card (K1), and
        # no fused host walker launches a kernel
        assert all((got["k1_launches"] > 0) == (not leg.endswith("_native"))
                   for leg, got in res["legs"].items()), res["legs"]
        print(f"[{card}] 4l rank {rank} of 2 (gloo): flagstat_multihost_bam, _bgzf_sam and "
              f"_cram, each on the card (K1) and impl=native = the oracle; K1 launches "
              + ", ".join(f"{leg} {got['k1_launches']}" for leg, got in res["legs"].items())
              + "; walls (s): " + ", ".join(f"{leg} {got['wall_s']:.3f}"
                                           for leg, got in res["legs"].items()))
    print(f"4l two-process legs: {wall:.2f} s wall for both workers, start-up included")
    os.remove(rans)   # phase 4m's multihost_scaling reuses the BAM and the BGZF SAM

    # the conformance tool, as a user runs it
    seen = dict(K.LAUNCHES)
    for argv in (["--container", "cram", "--scale", "8", "--workdir", tmp],
                 ["--scale", "8", "--workdir", tmp]):
        t0 = time.perf_counter()
        rc, _ = captured(argv, main=na12878_run.main)
        launched(seen, "flagstat")
        assert rc == 0, argv
        print(f"[{card}] 4l na12878_run {' '.join(argv[:-2])}: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s")


#: phase 4m: the seed of its stress run (printed; a MISMATCH replays
#: with it) and the scale of its codec sweep, 1/128 of NA12878 (6,441,727
#: words; cut for run time only: at the JAX default of 1/8, Zstd c16-20
#: over 206 MB would take minutes each)
STRESS_SEED = 1017
CODEC_SWEEP_SCALE = 128
#: "[kind] label: wall 0.12s (345 Mwords/s; 678 records; ..." of multihost_scaling
SCALING_LINE = re.compile(r"^\[(\w+)\] (\d)proc x (\d)T: wall [0-9.]+s \(\d+ Mwords/s; "
                          r"(\d+) records;")


def drive_remaining_tools(na_words: np.ndarray, na_path: str | None, tmp: str,
                          card: str) -> None:
    """Phase 4m: the last tools, perf_native and the entry points, each
    through its main() or its public call, on the card: stress at its
    defaults (K1, K3, K2 and K6 on ragged sizes), codegen,
    alignment_study at its defaults, codec_sweep_na12878 at 1/128,
    multihost_scaling over the NA12878 LZ4 file, the realistic BAM and
    the BGZF SAM, instrumented's perf block, graft_entry.entry() and
    dryrun_multichip(4) on the card's shards."""
    walls = {}

    def tool(name: str, argv: list, main) -> list:
        t0 = time.perf_counter()
        rc, lines = captured(argv, main)
        walls[name] = time.perf_counter() - t0
        assert rc == 0, (name, rc, lines[-20:])
        return lines

    def launched_all(before: dict, modes: tuple) -> None:
        assert all(K.LAUNCHES[m] > before[m] for m in modes), (modes, before, K.LAUNCHES)
        before.update(K.LAUNCHES)

    seen = dict(K.LAUNCHES)
    lines = tool("stress", ["--seed", str(STRESS_SEED)], stress.main)
    impls = stress.impls_for(torch.device("cuda"))
    assert len(impls) == 7 and lines[-1] == "stress OK: 50 rounds x 7 impls", lines[-3:]
    launched_all(seen, ("flagstat", "flagstat_report", "pre", "words"))
    print(f"[{card}] 4m stress --seed {STRESS_SEED}: 50 rounds up to 2,000,000 words, every "
          f"round = flagstat_numpy in {impls}")

    lines = tool("codegen", [], codegen.main)
    assert lines[-2:] == [codegen.WORD_TABLE_LINE, "OK"], lines[-2:]

    lines = tool("alignment_study", [], alignment_study.main)
    assert lines[0] == alignment_study.HEADER and len(lines) == 9, lines
    assert [ln.split("\t")[1] for ln in lines[1:]] == [str(o) for o in alignment_study.OFFSETS] * 2

    lines = tool("codec_sweep_na12878", [str(CODEC_SWEEP_SCALE)], codec_sweep_na12878.main)
    assert lines[0] == codec_sweep_na12878.HEADER and \
        [tuple(ln.split("\t")[:2]) for ln in lines[1:]] == \
        [(c, label) for c, _, label in codec_sweep_na12878.CONFIGS], lines
    launched_all(seen, ("flagstat",))
    print(f"[{card}] 4m codec_sweep_na12878 {CODEC_SWEEP_SCALE}: 39 configs; lz4, zstd and raw "
          f"counters = flagstat_numpy on the card (K1) and by the fused native pipeline")

    files = {"framed": na_path, "bam": os.path.join(tmp, "real.bam"),
             "bgzf_sam": os.path.join(tmp, "real.sam.gz")}
    words = na_words[:CONTAINER_WORDS]
    if files["framed"] is None:
        files["framed"] = os.path.join(tmp, "na12878.lz4")
        C.write_framed(files["framed"], na_words, "lz4", level=1)
    for kind, write in (("bam", write_realistic_bam), ("bgzf_sam", write_bgzf_sam)):
        if not os.path.exists(files[kind]):
            write(files[kind], words)
    lines = tool("multihost_scaling", ["--file", files["framed"], "--sam-gz", files["bgzf_sam"],
                                       "--bam", files["bam"], "--iters", "1"],
                 multihost_scaling.main)
    want = {"framed": na_words.size, "bam": words.size, "bgzf_sam": words.size}
    worlds = [m.groups() for m in map(SCALING_LINE.match, lines) if m]
    assert sorted((k, p, t) for k, p, t, _ in worlds) == sorted(
        (k, str(p), str(t)) for k in want for p, t, _ in multihost_scaling.WORLDS), lines
    assert all(int(n) == want[k] for k, _, _, n in worlds), (worlds, want)
    ratios = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["kind"] for r in ratios] == list(multihost_scaling.KINDS), lines
    print(f"[{card}] 4m multihost_scaling: 3 worlds (1x2T, 1x4T, 2x2T over gloo) over the "
          f"NA12878 LZ4 file, the realistic BAM and the BGZF SAM, every record count = the "
          f"file's")

    lines = tool("instrumented", ["instrumented", "-n", str(1 << 20), "-i", "1",
                                  "--no-roofline"], cli.main)
    rows = instrumented.rows(lines)
    block = lines[len(rows) + 2:]
    assert len(rows) == 6 and lines[len(rows) + 1] == "" and block, lines
    if block[0].startswith("perf_event unavailable: "):
        perf = block[0]
    else:
        kinds = [ln.split("\t")[2] for ln in block[1:3]]
        assert block[0].startswith("kernel\twords\tcounted\t") and \
            [ln.split("\t")[0] for ln in block[1:3]] == ["lfs_flagstat_u16",
                                                         "lfs_pospopcnt_u16"], block
        assert set(kinds) <= {"hw", "sw-only"}, block
        perf = f"perf rows {kinds[0]}: events " + ", ".join(block[0].split("\t")[3:])
    print(f"[{card}] 4m instrumented perf block: {perf}")

    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    got = fn(*args).cpu().numpy()
    want_entry = flagstat_numpy(args[0].cpu().numpy().view(np.uint16)).astype(np.int64)
    assert args[0].is_cuda and np.array_equal(got, want_entry), (got, want_entry)
    launched_all(seen, ("flagstat",))
    graft_entry.dryrun_multichip(4)
    launched_all(seen, ("flagstat", "pre"))
    walls["graft_entry"] = time.perf_counter() - t0
    print(f"[{card}] 4m graft_entry: entry() fn(*args) on {args[0].numel()} words on the card = "
          f"flagstat_numpy; dryrun_multichip(4) on the card's shards: every leg = the oracle")
    print(f"[{card}] 4m walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))


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
    """Phase 5: K1's modes against their plain versions, CUDA events,
    median of runs."""
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
    return times


def ptxas_usage(source: str) -> str | None:
    """ptxas's "Used N registers, ... smem" line for the one kernel of
    ``source`` in this process's build, or None (a cached build)."""
    text = cuda_build.BUILD_LOG.split(os.path.basename(source) + ":", 1)
    used = [line.split(":", 1)[1].strip() for line in text[-1].splitlines()
            if "Used" in line and "registers" in line] if len(text) == 2 else []
    return used[0] if used else None


def time_words_kernel(na_words: np.ndarray, card: str) -> dict:
    """Phase 5c: K6 beside K1 (the same count, bit-sliced), K4 (the read
    roofline), its plain version and its bound (the words read once),
    CUDA events, median of runs: at 64Mi on three word distributions
    (the table lookup's bank conflicts differ) and on the NA12878 column;
    and at one turn per block of a full wave, where the table's prologue
    is the largest share. "alone" is the launch without the wrapper's
    checks, its zeroing of the sums and the epilogue kernel after it."""
    times = {}
    lib = cuda_build.load()
    out = torch.zeros(2 * W.BITS, dtype=torch.int64, device="cuda")

    def alone(x):
        stream = torch.cuda.current_stream().cuda_stream
        assert lib.lfs_stream_sums_words(x.data_ptr(), x.numel(), out.data_ptr(), 0, 0,
                                         stream) == 0
        return median_ms(lambda: lib.lfs_stream_sums_words(x.data_ptr(), x.numel(),
                                                           out.data_ptr(), 0, 0, stream), 7, 10)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = W.words_wave_blocks()
    print(f"[{card}] K6: {wave} blocks a wave = {wave / sms:g} per SM; ptxas: "
          f"{ptxas_usage(WORDS_SOURCE)}")
    shapes = [(f"64Mi {name}", make(WORDS_64MI)) for name, make in WORDS_DISTRIBUTIONS]
    shapes.append(("NA12878", na_words))
    for label, words in shapes:
        x = torch.from_numpy(words).cuda()
        n = x.numel()
        ms = median_ms(lambda: W.stream_sums_words_cuda(x), 7, 10)
        alone_ms = alone(x)
        k1_ms = median_ms(lambda: K.stream_sums_cuda(x, "flagstat"), 7, 10)
        k4_ms = median_ms(lambda: P.read_xor_cuda(x), 7, 10)
        plain_ms = median_ms(lambda: W.stream_sums_words_plain(x), 3, 1)
        bound = bound_ms(2 * n, 2 * W.BITS)
        times[label] = (ms, plain_ms)
        print(f"[{card}] {label} {n} words K6: kernel {ms:.4f} ms ({2 * n / ms / 1e6:.1f} GB/s "
              f"read; alone {alone_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes; kernel at {bound / ms:.3f} of it); K1 flagstat {k1_ms:.4f} ms, K4 "
              f"read_xor {k4_ms:.4f} ms (K6 = {ms / k4_ms:.3f}x K4)")
        del x
    n = W.words_wave_words()
    x = torch.from_numpy(generate_flags(n, seed=17, full_range=True)).cuda()
    ms = median_ms(lambda: W.stream_sums_words_cuda(x), 7, 10)
    alone_ms = alone(x)
    k4_ms = median_ms(lambda: P.read_xor_cuda(x), 7, 10)
    print(f"[{card}] one turn per block ({n} words, {wave} blocks): K6 {ms:.4f} ms (alone "
          f"{alone_ms:.4f} ms), K4 {k4_ms:.4f} ms: K6's launch alone, the table's prologue "
          f"included, costs {(alone_ms - k4_ms) * 1e3:.1f} us over K4's call")
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


#: the repeat at which phase 5d holds each probe's time to at least
#: GROWTH_MIN x its time at repeat 1: its stage's integer work then
#: clearly outlasts the read it hides in at repeat 1 (a transform rep
#: costs ~1/30 of the read at 64Mi), and a rep loop nvcc folded stays flat
GROWTH_REPEAT = {"transpose_xor": 8, "raw": 8, "transform_xor": 128}
GROWTH_MIN = 1.5


def probe_bound_ms(key: str, n: int) -> tuple[float, str]:
    """The least time of a probe over n words (whole groups) at repeat 1:
    the larger of its bytes (input read once, output written once) over
    the nominal device-memory rate and, for each class of its 32-bit
    integer operations, their count over the class's rate."""
    groups = -(-n // GW)
    rows = P.PLANE_ROWS_READ.get(key)
    in_bytes = groups * rows * 4096 if rows else 2 * n
    out_bytes = 8 * 32 if key == "raw" else 4
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops * n / INT_OPS_PER_S[c] * 1e3 for c, ops in P.probe_ops(key).items())
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_probe_kernels(na_words: np.ndarray, card: str) -> dict:
    """Phase 5d: K4 and the three probes at repeat 1, at 64Mi and
    NA12878, each beside its plain version and its bound (CUDA events,
    median of runs), K4 beside the float32-view sum's read rate."""
    times = {}
    x64 = generate_flags(WORDS_64MI, seed=11, full_range=True)
    for label, words in (("64Mi", x64), ("NA12878", na_words)):
        x = torch.from_numpy(words).cuda()
        planes = torch.from_numpy(B.pretranspose_host(words)).cuda()
        n = x.numel()
        calls = {"read_xor": (lambda: P.read_xor_cuda(x), lambda: P.read_xor_plain(x)),
                 "transpose_xor": (lambda: P.transpose_xor_cuda(x), lambda: P.transpose_xor_plain(x)),
                 "transform_xor": (lambda: P.transform_xor_pre_cuda(planes),
                                   lambda: P.transform_xor_pre_plain(planes)),
                 "raw": (lambda: P.stream_sums_raw_cuda(planes), lambda: P.stream_sums_raw_plain(planes))}
        ref_ms = median_ms(lambda: x.view(torch.float32).sum(), 7, 10)
        for key, (kernel, plain) in calls.items():
            ms = median_ms(kernel, 7, 10)
            plain_ms = median_ms(plain, 3, 1)
            bound, by = probe_bound_ms(key, n)
            times[(label, key)] = (ms, plain_ms)
            print(f"[{card}] {label} {n} words {key}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}); {2 * n / ms / 1e6:.1f} GB/s of the words' bytes")
        print(f"[{card}] {label}: K4 read_xor {times[(label, 'read_xor')][0]:.4f} ms "
              f"({2 * n / times[(label, 'read_xor')][0] / 1e6:.1f} GB/s) beside the float32-view "
              f"sum {ref_ms:.4f} ms ({2 * n / ref_ms / 1e6:.1f} GB/s)")
        cap = max((2 ** 31 - 1) // (planes.shape[0] * GW), 1)   # the count's repeat rule
        probe = {"transpose_xor": lambda r: P.transpose_xor_cuda(x, r),
                 "transform_xor": lambda r: P.transform_xor_pre_cuda(planes, r),
                 "raw": lambda r: P.stream_sums_raw_cuda(planes, min(r, cap))}
        for r in (1, 2, 4, 8):
            t = {key: median_ms(lambda: fn(r), 5, 5) for key, fn in probe.items()}
            print(f"[{card}] {label} repeat {r}: transpose {t['transpose_xor']:.4f} ms, "
                  f"transform {t['transform_xor']:.4f} ms, count at repeat {min(r, cap)} "
                  f"{t['raw']:.4f} ms")
        # every rep really runs: the time grows with repeat
        for key, r in GROWTH_REPEAT.items():
            if key == "raw" and r > cap:
                print(f"{label}: the count's repeat rule caps it at {cap}; growth checked at 64Mi")
                continue
            t1, tr = median_ms(lambda: probe[key](1), 5, 5), median_ms(lambda: probe[key](r), 5, 5)
            print(f"[{card}] {label} {key}: repeat {r} {tr:.4f} ms = {tr / t1:.2f}x repeat 1 "
                  f"{t1:.4f} ms (must be >= {GROWTH_MIN}x)")
            assert tr >= GROWTH_MIN * t1, (label, key, r, tr, t1)
        del x, planes
    return times


def time_fold_and_setop(na_words: np.ndarray, card: str) -> dict:
    """Phase 5e: K8's three cases at 64Mi words (1024 groups) and K9's
    popcnt and intersect at 64Mi words and at NA12878's bytes, each
    beside its plain version and its bound (the bytes it must read over
    the nominal device-memory rate), CUDA events, median of runs."""
    times = {}
    rng = np.random.default_rng(23)
    groups = WORDS_64MI // GW
    host32 = rng.integers(0, 1 << 32, size=(groups, 32, 8, 128), dtype=np.uint64).astype(np.uint32)
    planes = {False: torch.from_numpy(host32.view(np.int32)).cuda()}
    planes[True] = planes[False][:, sorted(B.NEEDED_ROWS)].contiguous()
    for name, packed, rows in FOLD_CASES:
        t = planes[packed]
        nbytes = groups * (len(rows) if rows else t.shape[1]) * 4096
        ms = median_ms(lambda: P.fold_xor_cuda(t, rows), 7, 10)
        plain_ms = median_ms(lambda: P.fold_xor_plain(t, rows), 5, 1)
        times[("64Mi", name)] = (ms, plain_ms, (nbytes + 4) / HBM_BYTES_PER_S * 1e3)
        print(f"[{card}] 64Mi K8 fold_xor {name}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} "
              f"GB/s of its rows), plain {plain_ms:.4f} ms, bound "
              f"{times[('64Mi', name)][2]:.4f} ms (bytes)")
    full = times[("64Mi", "full32")][0]
    print(f"[{card}] K8 sub24/full32 = {times[('64Mi', 'sub24')][0] / full:.3f}, pack24/full32 = "
          f"{times[('64Mi', 'pack24')][0] / full:.3f} (0.75 = the whole traffic cut)")
    del planes

    x64 = generate_flags(WORDS_64MI, seed=11, full_range=True)
    for label, words in (("64Mi", x64), ("NA12878", na_words)):
        a = torch.from_numpy(words).cuda().view(torch.int32)
        b = torch.from_numpy(np.random.default_rng(29).integers(
            0, 1 << 32, size=a.numel(), dtype=np.uint32).view(np.int32)).cuda()
        k4_ms = median_ms(lambda: P.read_xor_cuda(a.view(torch.int16)), 7, 10)
        for op, second in (("popcnt", None), ("intersect", b)):
            nbytes = 4 * a.numel() * (1 if second is None else 2)
            ms = median_ms(lambda: SA.setop_count_cuda(a, second, op), 7, 10)
            plain_ms = median_ms(lambda: SA.setop_count_plain(a, second, op), 3, 1)
            times[(label, op)] = (ms, plain_ms, (nbytes + 8) / HBM_BYTES_PER_S * 1e3)
            print(f"[{card}] {label} K9 setop_count {op} over {nbytes} bytes: kernel {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, bound "
                  f"{times[(label, op)][2]:.4f} ms (bytes); K4 over one bitmap {k4_ms:.4f} ms")
        del a, b
    return times


def time_matmul_tier(na_words: np.ndarray, card: str) -> dict:
    """Phase 5f: the "torch_matmul" pospopcnt tier, a library GEMM
    (torch._int_mm on the tensor cores) and no kernel of the port, at
    64Mi full-range words and on the NA12878 column: through the entry
    point on the card, held against K5 and the host count
    (max_abs_err 0), then timed beside K5 by CUDA events (median_ms),
    and its device launches per call counted in a profiler trace.
    Prints its rows as one JSON line of their own."""
    from torch.profiler import ProfilerActivity, profile

    rows = []
    x64 = generate_flags(WORDS_64MI, seed=11, full_range=True)
    for label, words in (("64Mi", x64), ("NA12878", na_words)):
        want = pospopcnt_hist(words)
        if label == "64Mi":
            assert (pospopcnt_np(words) == want).all()
        x = torch.from_numpy(words).cuda()
        got = L.pospopcnt_u16(x, impl="torch_matmul").astype(np.int64)
        k5 = K.stream_sums_cuda(x, "pospopcnt").cpu().numpy().astype(np.int64)
        err = int(max(np.abs(got - want).max(), np.abs(got - k5).max()))
        assert err == 0 and (k5 == want).all(), (label, got, k5, want)

        def tier():
            return T.pospopcnt_u16_matmul(x, chunk=D.MATMUL_CHUNK)

        ms = median_ms(tier, 5, 2)
        k5_ms = median_ms(lambda: K.stream_sums_cuda(x, "pospopcnt"), 7, 10)
        # the step's size against the dispatch's choice, at 64Mi only
        chunk_ms = {c: median_ms(lambda: T.pospopcnt_u16_matmul(x, chunk=c), 5, 2)
                    for c in MATMUL_CHUNKS} if label == "64Mi" else {}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tier()
            torch.cuda.synchronize()
        device_events = [e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
        gemms = sorted({e.name for e in device_events if "gemm" in e.name.lower()
                        or "imma" in e.name.lower() or "cutlass" in e.name.lower()})
        # where a call's device time goes: us summed per kernel name
        by_kernel = {}
        for e in device_events:
            key = e.name[:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + e.time_range.elapsed_us()
        n = x.numel()
        row = {"name": "pospopcnt_u16_matmul", "route": "library GEMM (torch._int_mm), "
               "not a kernel of the port", "source": "libflagstats_tpu_torch/ops/torch_ops.py",
               "replaces": "libflagstats_tpu/ops/xla_ops.py:98", "shape": label, "words": n,
               "chunk": D.MATMUL_CHUNK, "steps": -(-n // D.MATMUL_CHUNK),
               "launches_per_call": len(device_events) or "not measured",
               "gemm_kernels": gemms[:4],
               "device_us_by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])),
               "max_abs_err": err, "ms": ms, "k5_ms": k5_ms,
               "bound_ms": bound_ms(2 * n, 16), "bound_by": "bytes", "chunk_ms": chunk_ms}
        rows.append(row)
        print(f"[{card}] {label} {n} words, torch_matmul (library GEMM, not a kernel of the "
              f"port): {ms:.4f} ms, K5 {k5_ms:.4f} ms, bound {row['bound_ms']:.4f} ms; "
              f"{row['steps']} steps of {D.MATMUL_CHUNK} words, "
              f"{row['launches_per_call']} device launches a call; = K5 = host count"
              + "".join(f"; chunk {c}: {t:.4f} ms" for c, t in chunk_ms.items()))
        del x
    print(json.dumps({"library_gemm": rows}))
    return rows


#: phase 4o's traced call, run in a process of its own: a process's
#: second torch.profiler session (after phase 4j's) recorded no device
#: activity on the card's host. Prints the trace's event names.
TRACE_CALL = """
import json, torch
from torch.profiler import ProfilerActivity, profile
import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
x = generate_flags(1 << 22, seed=5, full_range=True)
xd = torch.from_numpy(x).cuda()
want = flagstat_numpy(x)
assert (L.flagstats_u16(xd) == want).all()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    got = L.flagstats_u16(xd)
    torch.cuda.synchronize()
assert (got == want).all()
print(json.dumps(sorted({e.key for e in prof.key_averages()})))
"""


def one_shot_walls(fn, calls: int) -> list[float]:
    """Host walls (s) of ``calls`` calls of fn(), each waiting for its
    result, after 20 untimed ones."""
    for _ in range(20):
        fn()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return walls


def plain_epilogue_call(xd: torch.Tensor) -> np.ndarray:
    """A card-tensor count ending as the port's counts ended before the
    epilogue kernel: K1 into a zeroed output, the two scatters of
    ``_sums_to_streams``, ``assemble_counters``' torch ops and a pageable
    readback."""
    sums = K.stream_sums_cuda(xd, "flagstat")
    return assemble_counters(*K._sums_to_streams(sums, False), xd.numel()).cpu().numpy()


def check_epilogue(na_words: np.ndarray, card: str) -> None:
    """Phase 4o: the epilogue kernel (ops/csrc/flagstat_epilogue.cu) on
    the card. (1) It equals its plain twin on random int64 sums of every
    kind, n up to 2^33, in both forms. (2) On the NA12878 column it
    equals assemble_counters over the plain _sums_to_streams of K1's,
    K3's and K6's sums, and every public card count (cuda, cuda_report,
    cuda_words on the resident column; cuda_pre staged from the host)
    gives the oracle's counters with one epilogue launch, also with the
    column split into DEVICE_WORD_CAP chunks (one count and one epilogue
    launch a chunk). (3) A torch.profiler trace of one resident call
    (TRACE_CALL, in a process of its own) holds K1 and the epilogue, and
    no pageable HtoD copy, index kernel or index_put_. (4) The host
    walls of resident calls beside the former ending
    (plain_epilogue_call), in turns."""
    gen = np.random.default_rng(20)
    for kind in K.EPILOGUE_KINDS:
        for _ in range(4):
            raw = gen.integers(0, 1 << 33, K.RAW_STREAMS[kind], dtype=np.int64)
            for m in (None, 0, 1 << 33, int(gen.integers(1 << 33))):
                got = K.epilogue_cuda(torch.from_numpy(raw).cuda(), kind, m).cpu()
                assert torch.equal(got, K.epilogue_plain(torch.from_numpy(raw), kind, m)), \
                    (kind, m)
    print("epilogue (1): kernel = plain twin on random sums below 2^33, every kind, both forms")

    n = na_words.size
    ref = oracle_counts(na_words).astype(np.int64)
    idx = list(F.REPORT_COUNTERS)
    xd = torch.from_numpy(na_words).cuda()
    acc = torch.empty(2 * W.BITS, dtype=torch.int64, device="cuda")
    for kind, raw, streams in (
            ("flagstat", K.stream_sums_cuda(xd, "flagstat"),
             lambda s: K._sums_to_streams(s, False)),
            ("flagstat_report", K.stream_sums_cuda(xd, "flagstat_report"),
             lambda s: K._sums_to_streams(s, True)),
            ("words", W.stream_sums_words_cuda(xd, out=acc, zero=True),
             W._pass_fail_to_streams)):
        want = assemble_counters(*streams(raw), n)
        got = K.epilogue_cuda(raw, kind, n)
        assert torch.equal(got, want), (kind, got, want)
        assert torch.equal(K.epilogue_cuda(raw, kind), torch.cat(streams(raw))), kind

    def check(c: np.ndarray, impl: str) -> None:
        c = c.astype(np.int64)
        if impl == "cuda_report":
            assert (c[idx] == ref[idx]).all() and (c[REPORT_ZEROS] == 0).all(), (impl, c)
        else:
            assert (c == ref).all(), (impl, c, ref)

    cap = D.DEVICE_WORD_CAP
    for chunks, word_cap in ((1, cap), (-(-n // EPILOGUE_CAP), EPILOGUE_CAP)):
        D.DEVICE_WORD_CAP = word_cap
        try:
            for impl in ("cuda", "cuda_report", "cuda_words", "cuda_pre"):
                before = dict(K.LAUNCHES)
                check(L.flagstats_u16(na_words if impl == "cuda_pre" else xd, impl=impl), impl)
                ran = {m: K.LAUNCHES[m] - before[m] for m in K.LAUNCHES}
                assert ran["epilogue"] == chunks, (impl, chunks, ran)
                if impl != "cuda_pre":
                    mode = {"cuda": "flagstat", "cuda_report": "flagstat_report",
                            "cuda_words": "words"}[impl]
                    assert ran[mode] == chunks, (impl, chunks, ran)
        finally:
            D.DEVICE_WORD_CAP = cap
        print(f"epilogue (2): NA12878 in {chunks} chunk(s): cuda, cuda_report, cuda_words "
              f"(resident) and cuda_pre (staged) = oracle, one epilogue launch a chunk")

    r = subprocess.run([sys.executable, "-c", TRACE_CALL], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    names = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"epilogue (3): one resident call's trace: {names}")
    assert any("stream_sums_kernel" in k for k in names), names
    assert any("epilogue_kernel" in k for k in names), names
    assert not [k for k in names if "HtoD" in k and "Pageable" in k], names
    assert not [k for k in names if "index" in k.lower()], names

    walls = {"epilogue kernel": [], "former ending": []}
    for _ in range(2):
        for label, fn in (("epilogue kernel", lambda: L.flagstats_u16(xd)),
                          ("former ending", lambda: plain_epilogue_call(xd))):
            walls[label] += one_shot_walls(fn, WALL_CALLS // 2)
    for label, w in walls.items():
        q = statistics.quantiles(w, n=10)
        print(f"[{card}] epilogue (4): resident NA12878 call, {label}: median "
              f"{statistics.median(w) * 1e3:.4f} ms, p90 {q[-1] * 1e3:.4f} ms over {len(w)} "
              f"calls (host clock, in turns)")


@contextlib.contextmanager
def phase(name: str):
    """Print what a phase took (host clock), so a run says where its time went."""
    t0 = time.perf_counter()
    yield
    print(f"[phase {name}: {time.perf_counter() - t0:.1f} s]", flush=True)


def parse_phases(argv=None) -> list[str]:
    """The phases to run, in PHASES order, then the SHAKEDOWNS named
    (default: every phase of PHASES). Exits 2 on a name that is neither."""
    ap = argparse.ArgumentParser(prog="chip_smoke.py", description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all): " + ",".join(PHASES)
                    + "; and only when named: " + ",".join(SHAKEDOWNS))
    chosen = [p.strip() for p in ap.parse_args(argv).phases.split(",") if p.strip()]
    unknown = [p for p in chosen if p not in PHASES + SHAKEDOWNS]
    if unknown or not chosen:
        ap.error(f"unknown phases {unknown}; choose from {','.join(PHASES + SHAKEDOWNS)}")
    return [p for p in PHASES + SHAKEDOWNS if p in chosen]


def zero_launches() -> None:
    for counts in (K.LAUNCHES, ST.STAGED):
        for key in counts:
            counts[key] = 0


def main(argv=None) -> int:
    t_start = time.perf_counter()
    run = parse_phases(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch sees none")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; phases {','.join(run)}")

    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    # the host library, the readers and the range column readers (g++)
    # build while nvcc builds the kernels
    with cf.ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(timed, load) for load in (native_lib.load,
                                                        native_lib.load_readers,
                                                        native_lib.load_columns)]
        t0 = time.perf_counter()
        path = cuda_build.build()
        cuda_build.load()
        print(f"built {path.name} in {time.perf_counter() - t0:.2f} s")
        host_seconds, readers_seconds, columns_seconds = (b.result() for b in builds)
    for line in cuda_build.BUILD_LOG.splitlines():
        if line.endswith(".cu:") or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    check_host_library(host_seconds, readers_seconds, columns_seconds)

    max_err = dict.fromkeys(K.LAUNCHES, 0)
    checks = {"3": check_kernels, "3b": check_pre_kernel, "3c": check_words_kernel,
              "3d": check_probe_kernels, "3e": check_fold_and_setop}
    with phase("3-3e, kernels against plain versions"):
        for name, check in checks.items():
            if name in run:
                with phase(name):
                    check(max_err)

    na = {}

    def na12878() -> np.ndarray:
        """The NA12878 column phase 4a made, or made now for a later phase."""
        if "words" not in na:
            t0 = time.perf_counter()
            na["words"] = synth_na12878(1)[0]
            print(f"synth_na12878(1): {na['words'].size} words, shuffled, made on the "
                  f"host in {time.perf_counter() - t0:.1f} s")
        return na["words"]

    launches = stream_launches = parallel_launches = measure_launches = tools_launches = None
    if "4a" in run:
        zero_launches()
        with phase("4a-d, in-memory entry points"):
            na["words"] = drive_main_path(card)
        launches = dict(K.LAUNCHES)
        print(f"main-path launches (phase 4 a-d): {launches}")
        assert all(launches[m] > 0 for m in K.MODES), launches

    with tempfile.TemporaryDirectory() as tmp:
        na_path = None
        if "4e" in run:
            zero_launches()
            with phase("4e-f, streaming"):
                na_path = drive_stream_path(na12878(), card, tmp)
            stream_launches = dict(K.LAUNCHES)
            print(f"streaming-path launches (phase 4 e-f): {stream_launches}")
            assert all(stream_launches[m] > 0 for m in K.PRE_MODES), stream_launches

        if "4g" in run:
            zero_launches()
            drive_words_path(na12878())
            print(f"word-space launches (phase 4g): {dict(K.LAUNCHES)}")
            assert K.LAUNCHES["words"] > 0

        if "4h" in run:
            if na_path is None:
                na_path = os.path.join(tmp, "na12878.lz4")
                C.write_framed(na_path, na12878(), "lz4", level=1)
            zero_launches()
            with phase("4h, data-parallel"):
                workers = drive_parallel_path(na12878(), na_path, tmp, card)
            parallel_launches = {m: K.LAUNCHES[m] + workers[m] for m in K.LAUNCHES}
            print(f"data-parallel launches (phase 4h): this process {dict(K.LAUNCHES)}, "
                  f"with its workers' {parallel_launches}")
            assert all(K.LAUNCHES[m] > 0 for m in ("flagstat", "flagstat_report", "pre",
                                                   "words")), K.LAUNCHES

        if "4i" in run:
            zero_launches()
            with phase("4i, measurement path"):
                drive_measurement_path()
            measure_launches = dict(K.LAUNCHES)
            print(f"measurement-path launches (phase 4i): {measure_launches}")
            # every kernel but the fold, which only the tools path launches
            assert all(v > 0 for m, v in measure_launches.items() if m != "fold_xor"), \
                measure_launches

        if "4j" in run:
            zero_launches()
            with tempfile.TemporaryDirectory() as tools_tmp, phase("4j, tools path"):
                drive_tools_path(na12878(), tools_tmp)
            tools_launches = dict(K.LAUNCHES)
            print(f"tools-path launches (phase 4j): {tools_launches}")
            assert tools_launches["fold_xor"] > 0 and tools_launches["setop"] > 0, tools_launches
            assert all(tools_launches[m] > 0
                       for m in K.MODES + K.PRE_MODES + ("words", "read_xor")), tools_launches

        if "4k" in run:
            na_words = na12878()
            zero_launches()
            with phase("4k, container path"):
                drive_container_path(na_words, na_path, tmp, card)
            container_launches = dict(K.LAUNCHES)
            print(f"container-path launches (phase 4k): {container_launches}")
            assert all(container_launches[m] > 0 for m in ("flagstat", "pre", "words")), \
                container_launches

        if "4l" in run:
            na_words = na12878()
            zero_launches()
            with phase("4l, CRAM, container legs and na12878_run"):
                drive_cram_path(na_words, tmp, card)
            cram_launches = dict(K.LAUNCHES)
            print(f"CRAM-path launches (phase 4l): {cram_launches}")
            assert all(cram_launches[m] > 0 for m in ("flagstat", "pre", "words")), \
                cram_launches

        if "4m" in run:
            na_words = na12878()
            zero_launches()
            with phase("4m, the last tools, perf_native and the entry points"):
                drive_remaining_tools(na_words, na_path, tmp, card)
            last_launches = dict(K.LAUNCHES)
            print(f"last-tools launches (phase 4m): {last_launches}")
            assert all(last_launches[m] > 0 for m in ("flagstat", "flagstat_report", "pre",
                                                       "words")), last_launches

        if "4n" in run:
            zero_launches()
            with phase("4n, a bad range of the framed-file leg in two ranks"):
                workers = drive_fault_path(tmp, card)
            print(f"fault-path launches (phase 4n): this process {dict(K.LAUNCHES)}, "
                  f"its workers' {workers}")

        if "4o" in run:
            zero_launches()
            with phase("4o, the epilogue kernel"):
                check_epilogue(na12878(), card)
            print(f"epilogue-path launches (phase 4o): {dict(K.LAUNCHES)}")
            assert K.LAUNCHES["epilogue"] > 0

    if "4s" in run:
        zero_launches()
        with phase("4s, the staging's shake-downs"):
            shake_down_staging(na12878(), card)

    timers = {"5": time_kernels, "5b": time_pre_kernel, "5c": time_words_kernel,
              "5d": time_probe_kernels, "5e": time_fold_and_setop, "5f": time_matmul_tier}
    results = {}
    with phase("5-5e, kernel times"):
        for name, timer in timers.items():
            if name in run:
                results[name] = timer(na12878(), card)
    assert "jax" not in sys.modules and "libflagstats_tpu" not in sys.modules
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(f"[chip_smoke: {time.perf_counter() - t_start:.1f} s in all]", flush=True)
    if not set(PHASES) <= set(run):
        # the kernel line needs every phase's launches and times
        print(card)  # as nvidia-smi --query-gpu=name,power.limit prints it
        print(json.dumps({"ok": True, "phases": run, "device": device}))
        return 0
    times, pre_times, words_times, probe_times, tool_times = (
        results[k] for k in ("5", "5b", "5c", "5d", "5e"))

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
        "ms": words_times["64Mi full-range"][0],
        "plain_ms": words_times["64Mi full-range"][1],
        "bound_ms": bound_ms(2 * WORDS_64MI, 2 * W.BITS),
        "bound_by": "bytes",
        "library_ms": None,
        "ptxas": ptxas_usage(WORDS_SOURCE),
    })
    # no single PyTorch call computes an xor fold or these probes
    kernels += [{
        "name": name,
        "route": "cuda",
        "source": PROBE_SOURCE,
        "replaces": replaces,
        "launches": measure_launches[key],
        "max_abs_err": max_err[key],
        "ms": probe_times[("64Mi", key)][0],
        "plain_ms": probe_times[("64Mi", key)][1],
        "bound_ms": probe_bound_ms(key, WORDS_64MI)[0],
        "bound_by": probe_bound_ms(key, WORDS_64MI)[1],
        "library_ms": None,
    } for name, key, replaces in PROBE_KERNELS]
    kernels += [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": tools_launches[key],
        "max_abs_err": max_err[key],
        "ms": tool_times[shape][0],
        "plain_ms": tool_times[shape][1],
        "bound_ms": tool_times[shape][2],
        "bound_by": "bytes",
        "library_ms": None,
    } for name, key, source, replaces, shape in (
        ("fold_xor_kernel", "fold_xor", PROBE_SOURCE, "tools/packed_probe.py:72",
         ("64Mi", "full32")),
        # no Pallas kernel: the XLA-fused population_count + sum
        ("setop_count_kernel<popcnt>", "setop", SETOP_SOURCE,
         "libflagstats_tpu/ops/setalgebra.py:29", ("64Mi", "popcnt")))]
    print(json.dumps({"kernels": kernels}))
    print(card)  # as nvidia-smi --query-gpu=name,power.limit prints it
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

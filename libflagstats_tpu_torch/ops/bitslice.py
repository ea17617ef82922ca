"""Bit-sliced flagstat: shared model, constants, and NumPy reference.

A copy of ``libflagstats_tpu.ops.bitslice``; tests/test_torch_modules.py
holds the constant tables and the numpy spec equal, and
tests/test_torch_pretranspose.py the host pretranspose byte for byte.
The port's plain twins (ops/kernels.py) run this exact discipline in
torch; the CUDA kernels (ops/csrc/flagstat_kernels.cu over raw words,
ops/csrc/flagstat_pre_kernels.cu over the pretransposed plane tiles
made here) count the same streams. The pretranspose functions may write
into a caller's ``out`` buffer, so the stream transposes straight into
pinned host memory.

This module defines the counting discipline of the Pallas kernels,
re-designed from the reference's AVX-512 Harley-Seal machinery
(reference: libflagstats.h:1646-1846 and libalgebra.h:2289-2319):

1. **Bit transpose.** Groups of 32 packed ``int32`` values (64 uint16 FLAG
   words) are bit-transposed with the classic masked-swap network (4
   stages here; the j=16 stage is elided — see TRANSPOSE_STAGES),
   yielding 32 "plane rows": row ``15-j`` holds bit ``j`` of the group's
   FIRST 32 words, row ``31-j`` bit ``j`` of the other 32 (verified by
   single-bit probes; each row is a pure 32-word plane and counting is
   word-order-free, so only the spec here cares). On TPU each "register"
   is a full (8,128) vreg tile, so one network invocation transposes
   8*128 = 1024 independent 32x32 bit blocks — this replaces the
   pshufb/movmskb tricks of the reference with pure VPU bitwise ops.

2. **Plane-space flagstat transform.** The samtools mask-select logic
   (reference: LOAD macro chain, libflagstats.h:281-290) becomes ~16
   boolean ops *per plane set*, i.e. one VPU op per 32 words — far
   cheaper than any word-space formulation.

3. **Stream counting.** Each counted plane is a stream of bit rows fed to
   a Harley-Seal carry-save adder tree (v1/v2/v4/v8 planes, periodic
   "sixteens" peel via SWAR popcount into int32 accumulators) — the exact
   discipline of STORM_pospopcnt_csa_avx512 mapped onto XOR/AND/OR VPU ops.

Counted streams (29): C_k = plane k of the transformed word for
k in 0..14, and F_k = C_k AND qcfail-plane for k != 9. Final counters:
pass[k] = C[k] - F[k], fail[k] = F[k], fail[9] = C[9],
pass[9] = n - C[9] (derived, reference: libflagstats.h:429).
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import flags as F
from ..io import native_lib

# ---- transpose network constants ----
# Masked-swap stages (j, mask) of the classic transpose32 network, with
# the j=16 stage ELIDED: that stage only exchanges whole 16-bit fields
# between registers — i.e. it permutes *which word* sits where, never
# mixing bit positions — and positional counting is word-order-free, so
# we simply relabel the input pairing as already-swapped and skip it
# (saves 96 of 432 ops per 32-register block; verified by brute force in
# tools/codegen.py and the bitslice tests).
TRANSPOSE_STAGES: tuple[tuple[int, int], ...] = (
    (8, 0x00FF00FF),
    (4, 0x0F0F0F0F),
    (2, 0x33333333),
    (1, 0x55555555),
)

# With the 4-stage network, bit j of the block's first 32 words lands in
# row 15 - j and of the other 32 words in row 31 - j (each row is a pure
# 32-word plane; every (word, bit) appears exactly once). The names say
# exactly that — an earlier even/odd-interleave framing was wrong.
def first_half_row(j: int) -> int:
    return 15 - j

def second_half_row(j: int) -> int:
    return 31 - j

# Planes consumed by the flagstat transform (input bits 12-15 ignored).
NEEDED_PLANES = tuple(range(12))
NEEDED_ROWS = frozenset(
    {first_half_row(j) for j in NEEDED_PLANES} | {second_half_row(j) for j in NEEDED_PLANES}
)

# Stream layout: 15 C-streams then 14 F-streams (k != 9), padded to 32 rows
# in the kernel's accumulator output.
N_PLANES = 15
C_STREAMS = tuple(range(N_PLANES))
F_STREAMS = tuple(k for k in range(N_PLANES) if k != F.FQCFAIL_OFF)
N_STREAMS = len(C_STREAMS) + len(F_STREAMS)  # 29

# "Report mode": only the counters samtools flagstat actually reports
# (drops the masked-positional PROPER/MUNMAP/REVERSE/MREVERSE counts the
# report never reads — the reference's improved3/4 variants make the
# same trade, libflagstats.h:2325-2428, and its conformance harness
# excludes those counters, inmemory.cpp:173-194). 21 streams vs 29.
REPORT_BITS = (0, 2, 6, 7, 8, 9, 10, 11, 12, 13, 14)
REPORT_C_STREAMS = REPORT_BITS
REPORT_F_STREAMS = tuple(k for k in REPORT_BITS if k != F.FQCFAIL_OFF)
N_REPORT_STREAMS = len(REPORT_C_STREAMS) + len(REPORT_F_STREAMS)  # 21
# REVERSE/MREVERSE planes are not needed at all in report mode (PROPER
# and MUNMAP still feed bits 12-14)
REPORT_NEEDED_PLANES = tuple(j for j in NEEDED_PLANES if j not in (4, 5))
REPORT_NEEDED_ROWS = frozenset(
    {first_half_row(j) for j in REPORT_NEEDED_PLANES}
    | {second_half_row(j) for j in REPORT_NEEDED_PLANES}
)


def swap_pairs(j: int) -> list[int]:
    """k-indices of the masked-swap pairs (k, k+j) for stage j."""
    return [k for k in range(32) if not (k & j)]


def pruned_pairs(needed_rows=NEEDED_ROWS) -> dict[int, list[int]]:
    """Per-stage swap pairs with unneeded output rows pruned.

    A pair (k, k+j) at a stage may be skipped iff neither output feeds a
    needed row downstream. Computed by backward reachability over the
    4-stage network (TRANSPOSE_STAGES — the j=16 stage is elided by the
    row relabeling above and does not participate).
    """
    needed = set(needed_rows)
    stages: dict[int, list[int]] = {}
    for j, _ in reversed(TRANSPOSE_STAGES):
        # every row belongs to exactly one pair at each stage; a skipped
        # pair passes its (unneeded) rows through unchanged
        pairs = [k for k in swap_pairs(j) if (k in needed or k + j in needed)]
        stages[j] = pairs
        needed = {r for k in pairs for r in (k, k + j)}
    return stages


# ---- NumPy reference of each kernel stage (used by tests and as the
# executable spec for the Pallas kernel) ----

def transpose32_np(regs: list[np.ndarray], prune: bool = False) -> list[np.ndarray]:
    """Masked-swap bit transpose of 32 uint32 'registers' (any trailing shape)."""
    A = [r.astype(np.uint32, copy=True) for r in regs]
    stages = pruned_pairs() if prune else {j: swap_pairs(j) for j, _ in TRANSPOSE_STAGES}
    for j, mask in TRANSPOSE_STAGES:
        m = np.uint32(mask)
        for k in stages[j]:
            t = (A[k] ^ (A[k + j] >> np.uint32(j))) & m
            A[k] = A[k] ^ t
            A[k + j] = A[k + j] ^ (t << np.uint32(j))
    return A


def transform_planes(p: list[np.ndarray], report: bool = False) -> list[np.ndarray]:
    """Flagstat mask-select transform in plane space.

    ``p[j]`` is the bit-plane of input FLAG bit j (j in 0..11; in report
    mode planes 4 and 5 may be None). Returns the 15 counted planes
    t[0..14] (entries 1,3,4,5 are None in report mode). Written against a
    minimal op surface (&, |, ^, ~) so the same code traces for NumPy and
    jnp inside Pallas.
    """
    secsup = p[8] | p[11]
    inpair = p[0] & ~secsup                 # paired, not secondary, not suppl.
    supc = p[11] & ~p[8]                    # supplementary counted iff not sec
    im = inpair & ~p[2]                     # pair branch & mapped
    t12 = im & p[1]                         # properly paired
    t13 = im & p[3]                         # singleton
    t14 = im ^ t13                          # both mates mapped (im & ~munmap)
    masked = (lambda j: None) if report else (lambda j: p[j] & inpair)
    return [
        inpair,                             # 0  FPAIRED (pair branch only)
        masked(1),                          # 1  FPROPER_PAIR (masked positional)
        p[2],                               # 2  FUNMAP (always)
        masked(3),                          # 3  FMUNMAP (masked positional)
        masked(4),                          # 4  FREVERSE (masked positional)
        masked(5),                          # 5  FMREVERSE (masked positional)
        p[6] & inpair,                      # 6  FREAD1
        p[7] & inpair,                      # 7  FREAD2
        p[8],                               # 8  FSECONDARY (always)
        p[9],                               # 9  FQCFAIL (always; the q plane)
        p[10],                              # 10 FDUP (always)
        supc,                               # 11 FSUPPLEMENTARY
        t12,                                # 12 properly paired
        t13,                                # 13 singleton
        t14,                                # 14 both mates mapped
    ]


def flagstat_bitsliced_np(array: np.ndarray) -> np.ndarray:
    """End-to-end NumPy model of the bit-sliced pipeline (no CSA staging).

    Returns the 32-counter vector; bit-exact vs the word-space oracles.
    Executable spec for the Pallas kernel's correctness.
    """
    arr = np.ascontiguousarray(np.asarray(array, dtype=np.uint16)).ravel()
    n = len(arr)
    pad = (-len(arr)) % 64
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint16)])
    packed = arr.view(np.uint32).reshape(-1, 32).T  # regs[k] = int32 k of group
    regs = [packed[k] for k in range(32)]
    rows = transpose32_np(regs, prune=True)

    counters = np.zeros(F.N_COUNTERS, dtype=np.uint64)
    csum = np.zeros(N_PLANES, dtype=np.uint64)
    fsum = np.zeros(N_PLANES, dtype=np.uint64)
    for row_of in (first_half_row, second_half_row):
        p = [rows[row_of(j)] for j in range(12)]
        t = transform_planes(p)
        q = t[F.FQCFAIL_OFF]
        for k in range(N_PLANES):
            csum[k] += popcount32_np(t[k]).sum()
            if k != F.FQCFAIL_OFF:
                fsum[k] += popcount32_np(t[k] & q).sum()
    n_fail = csum[F.FQCFAIL_OFF]
    for k in range(N_PLANES):
        if k == F.FQCFAIL_OFF:
            counters[k] = n - n_fail
            counters[16 + k] = n_fail
        else:
            counters[k] = csum[k] - fsum[k]
            counters[16 + k] = fsum[k]
    return counters


def _pad_groups(arr) -> np.ndarray:
    """Flat uint16 words zero-padded to whole 64Ki-word groups (zero
    padding is count-neutral)."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint16)).ravel()
    pad = (-arr.size) % (32 * 16 * 128)
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint16)])
    return arr


def _out_tiles(out, groups: int, n_rows: int) -> np.ndarray:
    """``out``, checked to be what the native transpose writes through a
    raw pointer, or a new (groups, n_rows, 8, 128) uint32 array."""
    shape = (groups, n_rows, 8, 128)
    if out is None:
        return np.empty(shape, dtype=np.uint32)
    if (out.shape != shape or out.dtype != np.uint32
            or not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]):
        raise ValueError(f"out must be a writable C-contiguous uint32 array "
                         f"of shape {shape}, got {out.dtype} {out.shape}")
    return out


def pretranspose_host_np(arr: np.ndarray) -> np.ndarray:
    """Host-side bit transpose: uint16 stream -> (groups, 32, 8, 128)
    uint32 plane tiles, byte-identical to what the in-kernel transpose
    produces after its uint16 -> uint32 sublane pairing + masked-swap
    network.

    This is the NumPy reference for the AVX2 implementation in
    io/csrc/flagstats_io.cpp (lfs_bit_transpose); the
    pretransposed kernel (K2) consumes this format and does no
    transpose.
    """
    arr = _pad_groups(arr)
    t = arr.reshape(-1, 32, 16, 128)
    # sublane pairing: row 2s = low half, row 2s+1 = high half
    regs = t[:, :, 0::2, :].astype(np.uint32) | (
        t[:, :, 1::2, :].astype(np.uint32) << 16
    )  # (G, 32, 8, 128)
    reg_list = [regs[:, k] for k in range(32)]
    rows = transpose32_np(reg_list)
    return np.stack(rows, axis=1)  # (G, 32, 8, 128)


def pretranspose_host(arr: np.ndarray, threads: int = 0, out=None) -> np.ndarray:
    """Host bit transpose for pretransposed ingest: AVX2 C++ when the
    native library is available (thread-pooled), NumPy otherwise.
    Pads the stream to whole 64Ki-word groups (zero padding is
    count-neutral); writes into ``out`` when given."""
    arr = _pad_groups(arr)
    out = _out_tiles(out, arr.size // (32 * 16 * 128), 32)
    lib = native_lib.load()
    if lib is None:
        out[...] = pretranspose_host_np(arr)
        return out
    r = lib.lfs_bit_transpose(
        arr.ctypes.data_as(ctypes.c_void_p), arr.size,
        out.ctypes.data_as(ctypes.c_void_p), threads,
    )
    if r != 0:
        raise RuntimeError("native bit transpose failed")
    return out


def pretranspose_host_packed(arr: np.ndarray, rows: tuple,
                             threads: int = 0, out=None) -> np.ndarray:
    """Packed host bit transpose: emit only the plane rows the device
    transform consumes — (G, len(rows), 8, 128) uint32 — cutting both
    the host store traffic and the device read by (32 - len(rows))/32
    (25% full mode, 37.5% report mode). ``rows`` is the packed row
    order (ops/kernels.PACKED_ROWS_*): unique, each in [0, 32). Writes
    into ``out`` when given."""
    rows = tuple(int(r) for r in rows)
    if (not 1 <= len(rows) <= 32 or len(set(rows)) != len(rows)
            or not all(0 <= r < 32 for r in rows)):
        raise ValueError(f"bad packed row list {rows}: rows must be unique "
                         "and in [0, 32)")
    arr = _pad_groups(arr)
    out = _out_tiles(out, arr.size // (32 * 16 * 128), len(rows))
    lib = native_lib.load()
    if lib is None:
        out[...] = pretranspose_host_np(arr)[:, list(rows)]
        return out
    rows_arr = np.asarray(rows, dtype=np.int32)
    r = lib.lfs_bit_transpose_packed(
        arr.ctypes.data_as(ctypes.c_void_p), arr.size,
        out.ctypes.data_as(ctypes.c_void_p),
        rows_arr.ctypes.data_as(ctypes.c_void_p), len(rows), threads,
    )
    if r != 0:
        raise RuntimeError(f"native packed bit transpose failed (rc={r})")
    return out


def popcount32_np(x: np.ndarray) -> np.ndarray:
    """SWAR popcount of uint32 (the kernel's v16 'peel' step)."""
    x = x.astype(np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> np.uint32(24)

"""The measurement kernels: the read roofline (K4), the three stage
probes (K7) and the plane-row fold (K8). CUDA wrappers and plain versions.

Port of ``libflagstats_tpu.ops.pallas_kernels`` ``read_xor_pallas``
(pallas_call ``:605``), ``transpose_xor_pallas`` (``:723``),
``transform_xor_pallas_pre`` (``:790``) and ``stream_sums_pallas_raw``
(modes ``"flagstat_raw"``/``"flagstat_raw@N"``, through ``:403``), and of
``make_fold.<locals>.fold`` of the JAX side's ``tools/packed_probe.py``
(pallas_call ``:72``). The benchmark harness (bench/harness.py) prices
every kernel against K4's read rate; tools/stage_decomposition.py
brackets the stages of K1 with K4 and the probes; tools/packed_probe.py
asks with K8 what the rows a kernel leaves unread cost.

* ``read_xor_cuda``, ``transpose_xor_cuda``, ``transform_xor_pre_cuda``,
  ``stream_sums_raw_cuda`` and ``fold_xor_cuda`` launch the hand-written
  sm_90a kernels (ops/csrc/flagstat_probe_kernels.cu) on a CUDA tensor,
  count their launches in ``kernels.LAUNCHES``, and take the plain
  version only for a tensor on the CPU. A CUDA tensor a kernel does not
  take raises.
* ``*_plain`` compute the same functions in torch, on CPU and CUDA
  tensors alike, by the rules of the port's other plain versions (int32
  lanes holding uint32 bits, masked ``>>``, SWAR popcount).

The three xor digests are (1,) int32 tensors holding the uint32 digest's
bits (``digest()`` reads the unsigned value); the count probe returns
(32,) int64 sums. The functions over uint16 words pair sublanes as the
TPU functions do: register k at (s, l) of group g is
``word[g, k, 2s, l] | word[g, k, 2s+1, l] << 16``, so a plain uint32 view
of the stream would give another digest.

``*_np`` are the host references in numpy, independent of torch: the
checks on the card and the stage decomposition gate the kernels against
them. ``PLANE_ROWS_READ`` and ``PROBE_OPS`` are the probes' work per
word, from which a caller prices them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import flags as F
from . import bitslice as B
from .kernels import (GROUP_WORDS, LANE, LAUNCHES, REGS, SUB, SUB16, _check_planes,
                      _popcount32, _transpose32, check_cuda_words)
from .torch_ops import as_words

#: groups per chunk of the plain versions (32Mi words, ~0.5 GB of
#: int32 intermediates)
PLAIN_CHUNK_GROUPS = 512
#: the transpose probe's fold rows (pallas_kernels.py:725)
FOLD_ROWS = tuple(sorted(B.NEEDED_ROWS))
#: plane rows of 32 that a probe over plane tiles loads per group: 12
#: of each half for the transform, 15 of each half for the count
PLANE_ROWS_READ = {"transform_xor": 24, "raw": 30}
#: the probes' 32-bit integer operations per input word, counted in
#: their source (ops/csrc/flagstat_probe_kernels.cu), not in SASS: nvcc
#: fuses up to three logic operations into one LOP3, so SASS holds fewer.
#: probe -> class -> (once per call, per rep); class "alu" is logic, add
#: and shift, "popc" is __popc.
#: * read_xor: 3 xors fold a 16-byte vector, 1 more into the accumulator,
#:   per 8 words.
#: * transpose_xor: a rep is 56 masked swaps of 6 operations (two shifts,
#:   three xors, an and); the fold 24 xors; per 64 words.
#: * transform_xor: a rep computes the 12 planes the next one reads (11,
#:   an and-not as 2) and xors them with the kernel's opaque 0 (12); the
#:   last rep computes 5 more, the fold is 15 xors, 14 ands and 14 xors;
#:   per half, 32 words.
#: * raw: a rep makes its two opaque 0s (2) and does 29 xors, 29 adds
#:   and 29 __popc, per 32 words.
PROBE_OPS = {
    "read_xor": {"alu": (4 / 8, 0.0)},
    "transpose_xor": {"alu": (24 / 64, 56 * 6 / 64)},
    "transform_xor": {"alu": ((5 + 43) / 32, (11 + 12) / 32)},
    "raw": {"alu": (0.0, (2 + 29 + 29) / 32), "popc": (0.0, 29 / 32)},
}


def probe_ops(key: str, repeat: int = 1) -> dict:
    """class -> 32-bit integer operations per word of one probe call."""
    return {c: once + repeat * rep for c, (once, rep) in PROBE_OPS[key].items()}


def digest(t: torch.Tensor) -> int:
    """The unsigned value of a (1,) int32 xor digest."""
    return int(t.reshape(-1)[0]) & 0xFFFFFFFF


def _check_repeat(repeat: int) -> None:
    if not isinstance(repeat, int) or not 1 <= repeat < 2 ** 31:
        raise ValueError(f"repeat must be an int in [1, 2**31), got {repeat!r}")


def _check_raw_repeat(groups: int, repeat: int) -> None:
    """The JAX function's int32 accumulator bound (pallas_kernels.py:661-669),
    kept so that both packages take the same inputs."""
    _check_repeat(repeat)
    max_repeat = max((2 ** 31 - 1) // (groups * GROUP_WORDS), 1)
    if repeat > max_repeat:
        raise ValueError(
            f"repeat={repeat} would overflow the int32 stream "
            f"accumulators at this size (max {max_repeat} for "
            f"{groups} groups)")


def _xor_all(t: torch.Tensor) -> torch.Tensor:
    """Xor of every element of an int32 tensor -> (1,) int32."""
    t = t.reshape(-1)
    if t.numel() == 0:
        return torch.zeros(1, dtype=torch.int32, device=t.device)
    while t.numel() > 1:
        if t.numel() % 2:
            t = torch.cat([t, t.new_zeros(1)])
        half = t.numel() // 2
        t = t[:half] ^ t[half:]
    return t


def _register_chunks(words: torch.Tensor):
    """(groups, 32, 8, 128) int32 registers of each chunk of the word
    stream, zero-padded to whole groups (zero words are xor-neutral)."""
    chunk = PLAIN_CHUNK_GROUPS * GROUP_WORDS
    for start in range(0, words.numel(), chunk):
        part = words[start:start + chunk]
        pad = (-part.numel()) % GROUP_WORDS
        if pad:
            part = torch.nn.functional.pad(part, (0, pad))
        w = part.to(torch.int32).view(-1, REGS, SUB16, LANE) & 0xFFFF
        yield w[:, :, 0::2] | (w[:, :, 1::2] << 16)


def _plane_chunks(planes: torch.Tensor):
    for start in range(0, planes.shape[0], PLAIN_CHUNK_GROUPS):
        part = planes[start:start + PLAIN_CHUNK_GROUPS]
        yield [part[:, k] for k in range(REGS)]


# ---- K4: the read roofline ----

def read_xor_plain(x) -> torch.Tensor:
    """Xor digest of a uint16 word stream -> (1,) int32: the low half is
    the xor of the words at index i with ``(i >> 7) & 1 == 0``, the high
    half the xor of the others (the sublane pairing of read_xor_pallas)."""
    words = as_words(x)
    d = torch.zeros(1, dtype=torch.int32, device=words.device)
    chunk = PLAIN_CHUNK_GROUPS * GROUP_WORDS
    for start in range(0, words.numel(), chunk):
        part = words[start:start + chunk]
        pad = (-part.numel()) % (2 * LANE)
        if pad:
            part = torch.nn.functional.pad(part, (0, pad))
        rows = (part.to(torch.int32) & 0xFFFF).view(-1, 2, LANE)
        d = d ^ _xor_all(rows[:, 0]) ^ (_xor_all(rows[:, 1]) << 16)
    return d


def read_xor_cuda(x: torch.Tensor) -> torch.Tensor:
    """K4's digest (see read_xor_plain) through the CUDA kernel.

    ``x``: a contiguous uint16 (or int16 view) tensor at any 2-byte
    aligned start. On a CUDA tensor this launches the kernel or raises; a
    CPU tensor takes the plain version."""
    if check_cuda_words(x):
        return read_xor_plain(x)
    out = torch.zeros(1, dtype=torch.int32, device=x.device)
    if x.numel():
        _launch("lfs_read_xor", x, x.data_ptr(), x.numel(), out.data_ptr())
        LAUNCHES["read_xor"] += 1
    return out


# ---- K7b: the transpose probe ----

def transpose_xor_plain(x, repeat: int = 1) -> torch.Tensor:
    """Transpose probe of a uint16 word stream -> (1,) int32: per group,
    the paired registers through ``bitslice.pruned_pairs()`` ``repeat``
    times (each rep on the last rep's rows, passthrough rows included),
    then the xor of the FOLD_ROWS planes, folded over everything."""
    _check_repeat(repeat)
    words = as_words(x)
    stages = B.pruned_pairs()
    d = torch.zeros(1, dtype=torch.int32, device=words.device)
    for regs in _register_chunks(words):
        rows = [regs[:, k] for k in range(REGS)]
        for _ in range(repeat):
            rows = _transpose32(rows, stages)
        acc = rows[FOLD_ROWS[0]]
        for r in FOLD_ROWS[1:]:
            acc = acc ^ rows[r]
        d = d ^ _xor_all(acc)
    return d


def transpose_xor_cuda(x: torch.Tensor, repeat: int = 1) -> torch.Tensor:
    """The transpose probe (see transpose_xor_plain) through the CUDA
    kernel; a CPU tensor takes the plain version."""
    _check_repeat(repeat)
    if check_cuda_words(x):
        return transpose_xor_plain(x, repeat)
    out = torch.zeros(1, dtype=torch.int32, device=x.device)
    if x.numel():
        _launch("lfs_transpose_xor", x, x.data_ptr(), x.numel(), repeat, out.data_ptr())
        LAUNCHES["transpose_xor"] += 1
    return out


# ---- K7c: the transform probe ----

def transform_xor_pre_plain(planes: torch.Tensor, repeat: int = 1) -> torch.Tensor:
    """Transform probe of (G, 32, 8, 128) plane tiles -> (1,) int32: per
    half, ``repeat`` times ``t = transform_planes(p); p = t[:12]``, then
    the xor of the C_STREAMS planes and of the F_STREAMS planes ANDed
    with the QC-fail plane."""
    _check_repeat(repeat)
    planes32, _ = _check_planes(planes, False, False)
    d = torch.zeros(1, dtype=torch.int32, device=planes32.device)
    for rows in _plane_chunks(planes32):
        acc = torch.zeros_like(rows[0])
        for half_of in (B.first_half_row, B.second_half_row):
            p = [rows[half_of(j)] for j in range(12)]
            for _ in range(repeat):
                t = B.transform_planes(p)
                p = t[:12]
            q = t[F.FQCFAIL_OFF]
            for k in B.C_STREAMS:
                acc = acc ^ t[k]
            for k in B.F_STREAMS:
                acc = acc ^ (t[k] & q)
        d = d ^ _xor_all(acc)
    return d


def transform_xor_pre_cuda(planes: torch.Tensor, repeat: int = 1) -> torch.Tensor:
    """The transform probe (see transform_xor_pre_plain) through the CUDA
    kernel; a CPU tensor takes the plain version."""
    _check_repeat(repeat)
    if _check_cuda_planes(planes, 4):
        return transform_xor_pre_plain(planes, repeat)
    out = torch.zeros(1, dtype=torch.int32, device=planes.device)
    if planes.shape[0]:
        _launch("lfs_transform_xor", planes, planes.data_ptr(), planes.shape[0], repeat,
                out.data_ptr())
        LAUNCHES["transform_xor"] += 1
    return out


# ---- K7a: the count probe ----

def stream_sums_raw_plain(planes: torch.Tensor, repeat: int = 1) -> torch.Tensor:
    """Count probe of (G, 32, 8, 128) plane tiles -> (32,) int64: entry
    k < 15 is the popcount of plane k (both halves), entries 15-28 those
    of the F_STREAMS planes, 29-31 are 0; all times ``repeat``."""
    planes32, _ = _check_planes(planes, False, False)
    out = torch.zeros(32, dtype=torch.int64, device=planes32.device)
    groups = planes32.shape[0]
    if groups == 0:
        return out
    _check_raw_repeat(groups, repeat)
    per_row = torch.zeros(REGS, dtype=torch.int64, device=planes32.device)
    for start in range(0, groups, PLAIN_CHUNK_GROUPS):
        part = planes32[start:start + PLAIN_CHUNK_GROUPS]
        per_row += _popcount32(part).sum(dim=(0, 2, 3))
    plane = [per_row[B.first_half_row(k)] + per_row[B.second_half_row(k)]
             for k in range(B.N_PLANES)]
    streams = list(B.C_STREAMS) + list(B.F_STREAMS)
    out[:len(streams)] = torch.stack([plane[k] for k in streams])
    return out * repeat


def stream_sums_raw_cuda(planes: torch.Tensor, repeat: int = 1) -> torch.Tensor:
    """The count probe (see stream_sums_raw_plain) through the CUDA
    kernel; a CPU tensor takes the plain version. On a CUDA tensor the
    tiles must be contiguous and 16-byte aligned."""
    if _check_cuda_planes(planes, 16):
        return stream_sums_raw_plain(planes, repeat)
    out = torch.zeros(32, dtype=torch.int64, device=planes.device)
    groups = planes.shape[0]
    if groups == 0:
        return out
    _check_raw_repeat(groups, repeat)
    _launch("lfs_stream_sums_raw", planes, planes.data_ptr(), groups, repeat, out.data_ptr())
    LAUNCHES["raw"] += 1
    return out


# ---- K8: the plane-row fold ----

#: row counts of the plane tiles the fold takes: every row, or the packed
#: 24 of ``kernels.PACKED_ROWS_FULL``
FOLD_TILE_ROWS = (32, 24)


def _fold_rows(planes, rows) -> tuple[int, ...]:
    """The chosen rows of (G, nrows, 8, 128) tiles, sorted; every row for
    None. Raises for tiles or rows the fold does not take."""
    if not isinstance(planes, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(planes).__name__}")
    if (planes.ndim != 4 or planes.shape[1] not in FOLD_TILE_ROWS
            or tuple(planes.shape[2:]) != (SUB, LANE)):
        raise ValueError(f"expected (G, 32 or 24, 8, 128) plane tiles, got {tuple(planes.shape)}")
    if planes.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"expected uint32 plane tiles or an int32 view, got {planes.dtype}")
    return _chosen_rows(planes.shape[1], None if rows is None else tuple(rows))


@functools.lru_cache(maxsize=64)
def _chosen_rows(nrows: int, rows) -> tuple[int, ...]:
    # cached: the wrapper's per-call host cost is in the timed region of
    # the harness
    chosen = tuple(range(nrows)) if rows is None else tuple(sorted(set(int(r) for r in rows)))
    if chosen and not 0 <= chosen[0] <= chosen[-1] < nrows:
        raise ValueError(f"rows must lie in [0, {nrows}), got {chosen}")
    return chosen


@functools.lru_cache(maxsize=64)
def _row_mask(chosen: tuple) -> int:
    return sum(1 << r for r in chosen)


def fold_xor_plain(planes: torch.Tensor, rows=None) -> torch.Tensor:
    """Xor of every uint32 of the rows ``rows`` (default: all) of
    (G, 32 or 24, 8, 128) plane tiles -> (1,) int32."""
    chosen = _fold_rows(planes, rows)
    planes32 = planes.view(torch.int32)
    d = torch.zeros(1, dtype=torch.int32, device=planes.device)
    if not chosen:
        return d
    index = torch.tensor(chosen, device=planes.device)
    for start in range(0, planes32.shape[0], PLAIN_CHUNK_GROUPS):
        d = d ^ _xor_all(planes32[start:start + PLAIN_CHUNK_GROUPS].index_select(1, index))
    return d


def fold_xor_cuda(planes: torch.Tensor, rows=None) -> torch.Tensor:
    """The fold (see fold_xor_plain) through the CUDA kernel, which never
    addresses a row outside ``rows``; a CPU tensor takes the plain
    version. On a CUDA tensor the tiles must be contiguous and 16-byte
    aligned; no group and an empty row set launch nothing."""
    chosen = _fold_rows(planes, rows)
    if planes.device.type == "cpu":
        return fold_xor_plain(planes, chosen)
    if planes.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {planes.device}")
    if not planes.is_contiguous():
        raise ValueError("the kernel reads contiguous plane tiles")
    if planes.data_ptr() % 16:
        raise ValueError("the kernel needs 16-byte aligned plane tiles")
    out = torch.zeros(1, dtype=torch.int32, device=planes.device)
    if planes.shape[0] and chosen:
        _launch("lfs_fold_xor", planes, planes.data_ptr(), planes.shape[0], planes.shape[1],
                _row_mask(chosen), out.data_ptr())
        LAUNCHES["fold_xor"] += 1
    return out


# ---- host references (numpy) ----

def fold_xor_np(planes: np.ndarray, rows=None) -> int:
    """K8's digest: the xor of every uint32 of the chosen rows (default:
    all) of (G, nrows, 8, 128) uint32 plane tiles."""
    part = planes if rows is None else planes[:, sorted(set(rows))]
    return int(np.bitwise_xor.reduce(part.ravel())) if part.size else 0


def read_xor_np(x: np.ndarray) -> int:
    """K4's digest: the xor of the words at index i with (i >> 7) & 1 == 0
    in the low half, of the others in the high half."""
    w = np.concatenate([x, np.zeros((-x.size) % 256, np.uint16)]).reshape(-1, 2, LANE)
    return (int(np.bitwise_xor.reduce(w[:, 0].ravel().astype(np.uint32)))
            | int(np.bitwise_xor.reduce(w[:, 1].ravel().astype(np.uint32))) << 16)


def transpose_xor_np(x: np.ndarray, repeat: int = 1) -> int:
    """K7b's digest: the sublane-paired registers through the pruned
    network ``repeat`` times, then the FOLD_ROWS fold."""
    t = np.concatenate([x, np.zeros((-x.size) % GROUP_WORDS, np.uint16)]).reshape(
        -1, REGS, SUB16, LANE)
    regs = t[:, :, 0::2, :].astype(np.uint32) | (t[:, :, 1::2, :].astype(np.uint32) << 16)
    rows = [regs[:, k] for k in range(REGS)]
    for _ in range(repeat):
        rows = B.transpose32_np(rows, prune=True)
    fold = np.zeros(regs.shape[:1] + regs.shape[2:], np.uint32)
    for r in FOLD_ROWS:
        fold ^= rows[r]
    return int(np.bitwise_xor.reduce(fold.ravel())) if fold.size else 0


def transform_xor_pre_np(planes: np.ndarray, repeat: int = 1) -> int:
    """K7c's digest of (G, 32, 8, 128) uint32 plane tiles: per half,
    ``repeat`` chained transforms, then the C planes and the F planes
    ANDed with QC-fail, folded."""
    fold = np.zeros(planes.shape[:1] + planes.shape[2:], np.uint32)
    for half_of in (B.first_half_row, B.second_half_row):
        p = [planes[:, half_of(j)] for j in range(12)]
        for _ in range(repeat):
            t = B.transform_planes(p)
            p = t[:12]
        q = t[F.FQCFAIL_OFF]
        for k in B.C_STREAMS:
            fold ^= t[k]
        for k in B.F_STREAMS:
            fold ^= t[k] & q
    return int(np.bitwise_xor.reduce(fold.ravel())) if fold.size else 0


def stream_sums_raw_np(pospopcnt: np.ndarray, repeat: int = 1) -> np.ndarray:
    """K7a's sums from the 16 positional popcounts of the words: the
    C_STREAMS then the F_STREAMS bits, 0 for 29-31, times ``repeat``."""
    out = np.zeros(32, np.int64)
    out[:len(B.C_STREAMS) + len(B.F_STREAMS)] = [pospopcnt[k] for k in B.C_STREAMS + B.F_STREAMS]
    return out * repeat


# ---- launch plumbing ----

def _check_cuda_planes(planes, align: int) -> bool:
    """True for (G, 32, 8, 128) tiles on the CPU; False for tiles a probe
    kernel takes; raises for anything else."""
    _check_planes(planes, False, False)
    if planes.device.type == "cpu":
        return True
    if planes.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {planes.device}")
    if not planes.is_contiguous():
        raise ValueError("the kernel reads contiguous plane tiles")
    if planes.data_ptr() % align:
        raise ValueError(f"the kernel needs {align}-byte aligned plane tiles")
    return False


def _launch(name: str, t: torch.Tensor, *args) -> None:
    from . import cuda_build

    lib = cuda_build.load()
    with torch.cuda.device(t.device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed: cudaError {err}")


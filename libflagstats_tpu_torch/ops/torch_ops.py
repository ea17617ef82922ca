"""Plain word-space flagstat and pospopcnt in torch — the ``"torch"`` tier.

The counterpart of ``libflagstats_tpu.ops.xla_ops``: the mask-select
transform as packed-SWAR bitwise ops on two words per 32-bit lane, and
the positional popcount as a shift-mask-sum per bit. It runs on any
device torch runs on, and is the device-side differential baseline of
the CUDA kernel. ``pospopcnt_u16_matmul`` is the ``"torch_matmul"``
tier: the positional popcount as an int8 bit expansion reduced by a
ones-matrix product (the tensor cores on the card).

torch has no unsigned 32-bit shifts on the CPU and no popcount, so
lanes are int32 holding uint32 bits. Every right shift here is masked,
so the arithmetic shift's sign fill never reaches a counted bit, and
every subtraction stays inside int32.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .. import flags as F
from ..bench import profiling

_ONE16 = 0x00010001


def as_words(x) -> torch.Tensor:
    """A 1-D int16 view of a uint16 word stream (numpy array or tensor).

    int16 is the storage type every torch device supports fully; the
    words are read back as unsigned with ``& 0xFFFF`` where it matters."""
    if isinstance(x, np.ndarray):
        if x.dtype != np.uint16:
            raise ValueError(f"expected uint16, got {x.dtype}")
        x = np.ascontiguousarray(x).view(np.int16)
        if x.flags.writeable:
            x = torch.from_numpy(x)
        else:
            with warnings.catch_warnings():
                # a read-only column (a file's mapping) is only ever read
                warnings.filterwarnings("ignore", "The given NumPy array is not writable")
                x = torch.from_numpy(x)
    if x.dtype == torch.uint16:
        x = x.view(torch.int16)
    if x.dtype != torch.int16:
        raise ValueError(f"expected uint16 or an int16 view, got {x.dtype}")
    return x if x.dim() == 1 else x.reshape(-1)


def _pack_lanes(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad to 256 words and pair lane halves into int32 lanes
    (words i and i+128 of each 256-word row; any pairing is count-neutral)."""
    x = as_words(x)
    pad = (-x.numel()) % 256
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))  # zero words count nothing
    x2 = x.reshape(-1, 256).to(torch.int32) & 0xFFFF
    return x2[:, :128] | (x2[:, 128:] << 16)


def _transform_words_packed(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-SWAR word transform + QC split (pallas_kernels.py:819-844).

    ``x``: int32 lanes holding two FLAG words. Returns (pass_words,
    fail_words) in the transformed bit layout of oracle.transform_words."""
    one = _ONE16
    x = x & 0x0FFF0FFF                     # drop input bits 12-15; x >= 0 now
    sec = (x >> 8) & one
    sup = (x >> 11) & one
    pair = x & one
    inpair = pair & (sec ^ one) & (sup ^ one)
    supc = sup & (sec ^ one)
    im = inpair & (((x >> 2) & one) ^ one)  # inpair & mapped
    b12 = im & (x >> 1) & one
    b13 = im & (x >> 3) & one
    b14 = im ^ b13

    pair_mask = (inpair << 8) - inpair     # 0x00FF per field when inpair
    keep = pair_mask | (F.KEEP_ALWAYS * _ONE16)
    t = (x & keep) | (supc << 11) | (b12 << 12) | (b13 << 13) | (b14 << 14)

    q = (x >> F.FQCFAIL_OFF) & one
    mq = (q << 16) - q                     # 0xFFFF per field when QC-fail
    tf = t & mq
    return t ^ tf, tf


def _bit_counts(t: torch.Tensor, n_bits: int = F.N_BITS) -> torch.Tensor:
    """(n_bits,) int64: how many 16-bit fields of ``t`` have bit k set."""
    out = []
    for k in range(n_bits):
        c = (t >> k) & _ONE16               # bits 0 and 16 only, k <= 15
        out.append(((c + (c >> 16)) & 3).sum())
    return torch.stack(out)


def stream_sums_torch(x) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw stratified stream sums (C[k], F[k]), each (16,) int64.

    The counterpart of ``xla_ops.stream_sums_xla``: C[k] counts
    transformed bit k over all words, F[k] over QC-fail words."""
    tp, tf = _transform_words_packed(_pack_lanes(x))
    fail = _bit_counts(tf)
    return _bit_counts(tp) + fail, fail


def stream_sums_from_numpy(total, fail, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(C[k], F[k]) sums from numpy (e.g. the JAX package's int32 psum
    payload or streaming checkpoint) as the port's int64 tensors."""
    def conv(a):
        a = np.asarray(a)
        if a.shape != (F.N_BITS,):
            raise ValueError(f"expected shape ({F.N_BITS},), got {a.shape}")
        return torch.as_tensor(a.astype(np.int64), device=device)

    return conv(total), conv(fail)


def assemble_counters(total: torch.Tensor, fail: torch.Tensor, n) -> torch.Tensor:
    """(C[k], F[k]) stream sums -> 32-counter vector (int64).

    pass[k] = C[k] - F[k]; fail[9] = C[9] (= number of QC-fail reads);
    pass[9] = n - C[9] (derived pass total, reference: libflagstats.h:429).
    ``n`` is the true word count: padding never reaches counter 9.
    Span ``lfs.assemble``."""
    with profiling.span("lfs.assemble"):
        total = torch.as_tensor(total).to(torch.int64)
        fail = torch.as_tensor(fail, device=total.device).to(torch.int64)
        n_fail = total[F.FQCFAIL_OFF]
        passed = total - fail
        passed[F.FQCFAIL_OFF] = int(n) - n_fail
        failed = fail.clone()
        failed[F.FQCFAIL_OFF] = n_fail
        return torch.cat([passed, failed])


def flagstat_torch(x, n=None) -> torch.Tensor:
    """Flagstat counters of a uint16 word stream -> (32,) int64."""
    words = as_words(x)
    total, fail = stream_sums_torch(words)
    return assemble_counters(total, fail, words.numel() if n is None else n)


def pospopcnt_u16_torch(x, n_bits: int = F.N_BITS) -> torch.Tensor:
    """Positional popcount of a uint16 stream -> (n_bits,) int64
    (the counterpart of ``xla_ops.pospopcnt_u16_xla``)."""
    return _bit_counts(_pack_lanes(x), n_bits)


#: most words a row of the matmul tier's bit matrix: 1024 words x 16 bits
#: = 16384 int8 columns, so the product has n wide enough to fill the
#: card with output tiles, where a (32 x 256) output ran on two blocks
_MM_MAX_ROW_WORDS = 1024
#: rows of its ones matrix: torch._int_mm on CUDA needs more than 16
_MM_ONES_ROWS = 32


def pospopcnt_u16_matmul(x, n_bits: int = F.N_BITS, chunk: int = 1 << 17) -> torch.Tensor:
    """Positional popcount by an int8 matrix product -> (n_bits,) int64,
    on the device of ``x`` (the counterpart of
    ``xla_ops.pospopcnt_u16_matmul``, the JAX package's MXU tier).

    Per ``chunk`` words (zero words pad the last one; they count
    nothing): each word's two bytes expand into an int8 (chunk, 16) bit
    matrix by uint8 shifts (bit j of a word is bit j % 8 of its byte
    j // 8, little-endian), which is then reduced by
    ``torch._int_mm``, int8 x int8 accumulated in int32: a (32, k) ones
    matrix times the bit matrix seen as (k, 16 w), w words a row (w =
    gcd(chunk / 8, 1024), k = chunk / w). Row 0 of the (32, 16 w)
    product, its w 16-column groups added, is the chunk's count; the
    chunks' counts add up in int64. ``torch.matmul`` on int8 would
    return int8 and wrap; the 32 rows, of which one is kept, and the
    multiples of 8 are what ``_int_mm`` accepts on CUDA, and the CPU runs
    the same layout.

    ``chunk`` follows the JAX function: max(128, min(chunk, n rounded up
    to 128)). It bounds the bit matrix at 16 bytes a word of the chunk;
    any chunk gives the same counts, so one not a multiple of 128 is
    rounded up to one (k must be a multiple of 8). The default is the
    JAX function's, 1 << 17 words; ``ops.dispatch`` calls it with
    ``MATMUL_CHUNK`` (1 << 22) so that a column of 64Mi words is 16
    steps, not 512."""
    if not 0 < n_bits <= F.N_BITS:
        raise ValueError(f"n_bits must be in 1..{F.N_BITS}, got {n_bits}")
    words = as_words(x)
    n = words.numel()
    chunk = max(128, min(chunk, -(-n // 128) * 128))
    chunk = -(-chunk // 128) * 128
    dev = words.device
    acc = torch.zeros(F.N_BITS, dtype=torch.int64, device=dev)
    if n == 0:
        return acc[:n_bits]
    row_words = math.gcd(chunk // 8, _MM_MAX_ROW_WORDS)
    k = chunk // row_words
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    ones = torch.ones(_MM_ONES_ROWS, k, dtype=torch.int8, device=dev)
    bits = torch.empty(chunk, 2, 8, dtype=torch.uint8, device=dev)
    for start in range(0, n, chunk):
        part = words[start:start + chunk]
        if part.numel() < chunk:
            part = torch.nn.functional.pad(part, (0, chunk - part.numel()))
        torch.bitwise_right_shift(part.view(torch.uint8).view(chunk, 2, 1), shifts, out=bits)
        bits.bitwise_and_(1)
        prod = torch._int_mm(ones, bits.view(torch.int8).view(k, row_words * F.N_BITS))
        acc += prod[0].view(row_words, F.N_BITS).sum(0)
    return acc[:n_bits]

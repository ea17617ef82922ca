"""The word-space flagstat kernel (K6): CUDA wrapper and plain version.

Port of ``libflagstats_tpu.ops.pallas_kernels`` ``_make_words_kernel``,
``_run_words_kernel`` (pallas_call at ``:928``), ``stream_sums_words``
and ``flagstat_pallas_words``: no bit transpose; the mask-select
transform runs on packed words (SWAR on two 16-bit fields per 32-bit
lane), two Harley-Seal trees count the pass and fail strata, and each
sixteens word is peeled bit by bit into packed 16-bit half accumulators.

* ``stream_sums_words_cuda(x)`` launches the hand-written sm_90a kernel
  (ops/csrc/flagstat_words_kernels.cu) on a CUDA tensor and takes the
  plain version only for a tensor on the CPU. There is no fallback: a
  CUDA tensor the kernel does not take raises.
* ``stream_sums_words_plain(x)`` restates the kernel's algorithm in
  torch, on CPU and CUDA tensors alike: each of ``PLAIN_THREADS`` lanes
  of a turn is one thread's HS-16 body of 32 words, and the packed
  halves are flushed every ``FLUSH_BODIES`` turns, the kernel's bound.

Both return (C[k], F[k]), each (16,) int64: C over all words, F over
QC-fail words (the JAX function's (total, fail)).
"""
from __future__ import annotations

import ctypes

import torch

from .. import flags as F
from .kernels import LAUNCHES, _check_blocks, _csa, check_cuda_words
from .torch_ops import _ONE16, _transform_words_packed, as_words, assemble_counters

BITS = 15          # transformed bit 15 is always 0
LANES = 16         # int32 lanes per HS-16 body
BODY_WORDS = 2 * LANES
#: a sixteens peel adds 16 to a packed field per body, and 16 * 4095 =
#: 65,520 <= 0xFFFF: the halves are flushed every 4095 bodies (the
#: kernel's kFlushBodies; module-level so tests can shrink it)
FLUSH_BODIES = 4095
#: bodies counted side by side per turn of the plain version (32Mi words)
PLAIN_THREADS = 1 << 20


def _hs16(v: list, d: list) -> torch.Tensor:
    """One HS-16 body (pallas_kernels.py:887-903): the 16 inputs ``d``
    into ``v`` = [v1, v2, v4, v8], updated in place; returns sixteens."""
    v[0], twos_a = _csa(v[0], d[0], d[1])
    v[0], twos_b = _csa(v[0], d[2], d[3])
    v[1], fours_a = _csa(v[1], twos_a, twos_b)
    v[0], twos_a = _csa(v[0], d[4], d[5])
    v[0], twos_b = _csa(v[0], d[6], d[7])
    v[1], fours_b = _csa(v[1], twos_a, twos_b)
    v[2], eights_a = _csa(v[2], fours_a, fours_b)
    v[0], twos_a = _csa(v[0], d[8], d[9])
    v[0], twos_b = _csa(v[0], d[10], d[11])
    v[1], fours_a = _csa(v[1], twos_a, twos_b)
    v[0], twos_a = _csa(v[0], d[12], d[13])
    v[0], twos_b = _csa(v[0], d[14], d[15])
    v[1], fours_b = _csa(v[1], twos_a, twos_b)
    v[2], eights_b = _csa(v[2], fours_a, fours_b)
    v[3], sixteens = _csa(v[3], eights_a, eights_b)
    return sixteens


def _field_bits(v: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """(BITS, threads): bit k of each field of ``v``, moved to bits 0 and
    16 (``& 0x00010001`` after the shift drops any sign fill)."""
    return (v.unsqueeze(0) >> shifts) & _ONE16


def _halves_sum(packed: torch.Tensor) -> torch.Tensor:
    """(rows, threads) packed halves -> (rows,) int64: low + high field.
    The high field may reach 0xFFFF, making the int32 negative, so the
    arithmetic ``>> 16`` is masked."""
    return ((packed & 0xFFFF) + ((packed >> 16) & 0xFFFF)).sum(dim=1, dtype=torch.int64)


def stream_sums_words_plain(x) -> tuple[torch.Tensor, torch.Tensor]:
    """(C[k], F[k]) of a uint16 word stream by the kernel's algorithm, on
    the device the tensor lies on. Pads the last turn with zero words
    (they count nothing)."""
    words = as_words(x)
    n = words.numel()
    dev = words.device
    if n == 0:
        zero = torch.zeros(F.N_BITS, dtype=torch.int64, device=dev)
        return zero, zero.clone()
    threads = min(PLAIN_THREADS, -(-n // BODY_WORDS))
    per_turn = threads * BODY_WORDS
    shifts = torch.arange(BITS, dtype=torch.int32, device=dev).view(-1, 1)
    zero = torch.zeros(threads, dtype=torch.int32, device=dev)
    trees = ([zero] * 4, [zero] * 4)                  # pass, fail: v1, v2, v4, v8
    packed = torch.zeros((2, BITS, threads), dtype=torch.int32, device=dev)
    counts = torch.zeros((2, BITS), dtype=torch.int64, device=dev)
    for turn, start in enumerate(range(0, n, per_turn), 1):
        part = words[start:start + per_turn]
        if part.numel() < per_turn:
            part = torch.nn.functional.pad(part, (0, per_turn - part.numel()))
        w = part.to(torch.int32).view(threads, LANES, 2) & 0xFFFF
        strata = _transform_words_packed(w[..., 0] | (w[..., 1] << 16))
        for s, (v, d) in enumerate(zip(trees, strata)):
            sixteens = _hs16(v, [d[:, i] for i in range(LANES)])
            packed[s] += _field_bits(sixteens, shifts) << 4
        if turn % FLUSH_BODIES == 0:
            counts += _halves_sum(packed.view(2 * BITS, threads)).view(2, BITS)
            packed.zero_()
    counts += _halves_sum(packed.view(2 * BITS, threads)).view(2, BITS)
    for s, v in enumerate(trees):
        for weight, vw in enumerate(v):
            counts[s] += _halves_sum(_field_bits(vw, shifts)) << weight
    return _pass_fail_to_streams(counts.view(-1))


def _pass_fail_to_streams(sums: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64[30] (pass bits 0-14, fail bits 0-14) -> (C[k], F[k]), each
    (16,) with bit 15 at 0."""
    pad = torch.zeros(1, dtype=torch.int64, device=sums.device)
    fail = torch.cat([sums[BITS:], pad])
    return torch.cat([sums[:BITS], pad]) + fail, fail


def stream_sums_words_cuda(x: torch.Tensor, blocks: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C[k], F[k]) through the CUDA kernel, each (16,) int64.

    ``x``: a contiguous uint16 (or int16 view) tensor. On a CUDA tensor
    this launches the kernel or raises; a CPU tensor takes the plain
    version. Any 2-byte aligned start is taken as it is. ``blocks`` as
    for ``kernels.stream_sums_cuda`` (one wave: ``words_wave_blocks``); a
    grid far below one wave makes one thread run many more bodies than
    FLUSH_BODIES."""
    blocks = _check_blocks(blocks)
    if check_cuda_words(x):
        return stream_sums_words_plain(x)
    out = torch.zeros(2 * BITS, dtype=torch.int64, device=x.device)
    if x.numel():
        from . import cuda_build

        lib = cuda_build.load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.lfs_stream_sums_words(x.data_ptr(), x.numel(), out.data_ptr(),
                                            blocks, stream)
        if err:
            raise RuntimeError(f"stream_sums_words kernel failed: cudaError {err}")
        LAUNCHES["words"] += 1
    return _pass_fail_to_streams(out)


def words_wave_blocks(device=None) -> int:
    """Blocks of K6 resident at once on ``device``: one full wave."""
    from . import cuda_build

    lib = cuda_build.load()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.lfs_words_wave_blocks(ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return blocks.value


def words_wave_words(device=None) -> int:
    """Words one full wave of K6's blocks covers on ``device`` (beyond
    it the grid-stride loop turns)."""
    from . import cuda_build

    return words_wave_blocks(device) * cuda_build.load().lfs_words_block_words()


def flagstat_cuda_words(x: torch.Tensor, n=None) -> torch.Tensor:
    """Flagstat counters of a uint16 word tensor through K6 -> (32,)
    int64. ``n`` is the true word count for the derived pass total."""
    total, fail = stream_sums_words_cuda(x)
    return assemble_counters(total, fail, x.numel() if n is None else n)

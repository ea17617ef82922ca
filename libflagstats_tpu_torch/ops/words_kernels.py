"""The word-space flagstat kernel (K6): CUDA wrapper and plain version.

Port of ``libflagstats_tpu.ops.pallas_kernels`` ``_make_words_kernel``,
``_run_words_kernel`` (``:847-947``, pallas_call at ``:928``),
``stream_sums_words`` and ``flagstat_pallas_words``: no bit transpose.
The TPU kernel transforms packed words by SWAR, counts the pass and fail
strata in two Harley-Seal trees and peels every sixteens word bit by bit,
~20 integer operations a word: on the H100 that issue, not the read,
bounded it (PERF.md). Redesigned for the card, a word costs ~5:

* the transform is one lookup in a 4096-entry table (input bits 0-11)
  that each block builds in shared memory from the SWAR transform; an
  entry holds the word's transformed bits in its low 16-bit field when it
  is a QC-pass word, in its high field when it is a QC-fail word;
* one Harley-Seal tree counts those pass|fail lanes, 16 a body;
* a second carry-save level takes each body's sixteens word, and its
  256s word is peeled into packed 16-bit half accumulators once per 16
  bodies, which are flushed every ``FLUSH_BODIES`` bodies.

* ``stream_sums_words_cuda(x)`` launches the hand-written sm_90a kernel
  (ops/csrc/flagstat_words_kernels.cu) on a CUDA tensor and takes the
  plain version only for a tensor on the CPU. There is no fallback: a
  CUDA tensor the kernel does not take raises.
* ``stream_sums_words_plain(x)`` restates the kernel's algorithm in
  torch, on CPU and CUDA tensors alike: each of ``PLAIN_THREADS`` rows of
  a turn is one thread's two bodies, and the level-2 tree, the peel and
  the flush follow the kernel's turn count.

Both return (C[k], F[k]), each (16,) int64: C over all words, F over
QC-fail words (the JAX function's (total, fail)); on the card the
epilogue kernel (``kernels.epilogue_cuda``, kind ``"words"``) forms them
from the kernel's pass and fail bit counts. Given ``out``, the wrapper
adds those int64[30] counts into it instead and returns it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import flags as F
from .kernels import (LAUNCHES, _check_blocks, _csa, accumulator, add_plain, check_cuda_words,
                      epilogue_cuda, launch_span)
from .torch_ops import _ONE16, _transform_words_packed, as_words, assemble_counters

BITS = 15          # transformed bit 15 is always 0
LANES = 16         # int32 lanes (one word each) per HS-16 body
BODY_WORDS = LANES
TURN_WORDS = 2 * BODY_WORDS   # a thread's words per turn (four uint4 loads)
TABLE_SIZE = 1 << 12          # the transform reads input bits 0-11
L2_TURNS = 8                  # turns per level-2 body: 16 sixteens words
#: a 256s peel adds 256 to a packed field per 16 bodies, and 256 * 255 =
#: 65,280 <= 0xFFFF < 256 * 256: the halves are flushed every 255 peels
#: (the kernel's kFlushBodies; a multiple of 16; module-level so tests
#: can shrink it)
FLUSH_BODIES = 255 * 2 * L2_TURNS
#: threads counted side by side per turn of the plain version (32Mi words)
PLAIN_THREADS = 1 << 20


def word_table(device=None) -> torch.Tensor:
    """(4096,) int32: entry i is the transformed word of i (input bits
    0-11) in the low 16-bit field for a QC-pass word, in the high field
    for a QC-fail word (the kernel's shared-memory table)."""
    i = torch.arange(0, TABLE_SIZE, 2, dtype=torch.int32, device=device)
    tp, tf = _transform_words_packed(i | ((i + 1) << 16))
    lo = (tp & 0xFFFF) | ((tf & 0xFFFF) << 16)       # entry 2p
    hi = ((tp >> 16) & 0xFFFF) | (tf & -0x10000)     # entry 2p + 1
    return torch.stack([lo, hi], dim=1).view(-1)


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
    """(BITS, threads) packed halves -> int64[30]: the low (pass) fields'
    sums, then the high (fail) fields'. The high field may reach 0xFFFF,
    making the int32 negative, so the arithmetic ``>> 16`` is masked."""
    return torch.cat([(packed & 0xFFFF).sum(dim=1, dtype=torch.int64),
                      ((packed >> 16) & 0xFFFF).sum(dim=1, dtype=torch.int64)])


def stream_sums_words_plain(x) -> tuple[torch.Tensor, torch.Tensor]:
    """(C[k], F[k]) of a uint16 word stream by the kernel's algorithm, on
    the device the tensor lies on. Pads the last turn with zero words
    (entry 0 of the table is 0: they count nothing)."""
    return _pass_fail_to_streams(_bit_counts_plain(x))


def _bit_counts_plain(x) -> torch.Tensor:
    """The kernel's output, int64[30] (pass bits 0-14, then fail bits
    0-14), by its algorithm."""
    if FLUSH_BODIES % (2 * L2_TURNS):
        raise ValueError(f"FLUSH_BODIES must be a multiple of {2 * L2_TURNS}, "
                         f"got {FLUSH_BODIES}")
    words = as_words(x)
    n = words.numel()
    dev = words.device
    if n == 0:
        return torch.zeros(2 * BITS, dtype=torch.int64, device=dev)
    table = word_table(dev)
    threads = min(PLAIN_THREADS, -(-n // TURN_WORDS))
    per_turn = threads * TURN_WORDS
    shifts = torch.arange(BITS, dtype=torch.int32, device=dev).view(-1, 1)
    zero = torch.zeros(threads, dtype=torch.int32, device=dev)
    v, w, pend = [zero] * 4, [zero] * 4, [zero] * 3   # v1..v8, w16..w128, carries
    packed = torch.zeros((BITS, threads), dtype=torch.int32, device=dev)
    counts = torch.zeros(2 * BITS, dtype=torch.int64, device=dev)
    peels = turn = 0
    for turn, start in enumerate(range(0, n, per_turn)):
        part = words[start:start + per_turn]
        if part.numel() < per_turn:
            part = torch.nn.functional.pad(part, (0, per_turn - part.numel()))
        lanes = table[(part.to(torch.int32) & 0xFFF).view(threads, TURN_WORDS).long()]
        s0 = _hs16(v, [lanes[:, i] for i in range(LANES)])
        s1 = _hs16(v, [lanes[:, LANES + i] for i in range(LANES)])
        # level 2: an HS-16 body over the sixteens words of 8 turns
        w[0], c32 = _csa(w[0], s0, s1)
        if not turn & 1:
            pend[0] = c32
            continue
        w[1], c64 = _csa(w[1], pend[0], c32)
        if not turn & 2:
            pend[1] = c64
            continue
        w[2], c128 = _csa(w[2], pend[1], c64)
        if not turn & 4:
            pend[2] = c128
            continue
        w[3], c256 = _csa(w[3], pend[2], c128)
        packed += _field_bits(c256, shifts) << 8
        peels += 1
        if peels * 2 * L2_TURNS == FLUSH_BODIES:
            counts += _halves_sum(packed)
            packed.zero_()
            peels = 0
    turns = turn + 1
    for j in range(4):
        packed += _field_bits(v[j], shifts) << j
        packed += _field_bits(w[j], shifts) << (4 + j)
    for j in range(3):
        if turns >> j & 1:                            # a carry still pending
            packed += _field_bits(pend[j], shifts) << (5 + j)
    counts += _halves_sum(packed)
    return counts


def _pass_fail_to_streams(sums: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64[30] (pass bits 0-14, fail bits 0-14) -> (C[k], F[k]), each
    (16,) with bit 15 at 0: the plain version of the epilogue's first
    form (kind ``"words"``)."""
    both = torch.nn.functional.pad(sums.view(2, BITS), (0, 1))
    return both[0] + both[1], both[1]


def stream_sums_words_cuda(x: torch.Tensor, blocks: int | None = None,
                           out: torch.Tensor | None = None, zero: bool = False):
    """(C[k], F[k]) through the CUDA kernel, each (16,) int64.

    ``x``: a contiguous uint16 (or int16 view) tensor. On a CUDA tensor
    this launches the kernel and the epilogue kernel, or raises; a CPU
    tensor takes the plain version. Any 2-byte aligned start is taken as
    it is. ``blocks`` as for ``kernels.stream_sums_cuda`` (one wave:
    ``words_wave_blocks``); a grid far below one wave makes one thread
    run many more bodies than FLUSH_BODIES. Given ``out``, an int64
    accumulator on ``x``'s device, the kernel's pass and fail bit counts
    (int64[30]) are added into it (``zero``: zeroed first, in the
    launcher) and it is returned, with no epilogue."""
    with launch_span("words", x):
        blocks = _check_blocks(blocks)
        if check_cuda_words(x):
            if out is None:
                return stream_sums_words_plain(x)
            return add_plain(out, _bit_counts_plain(x), zero)
        acc, zero = accumulator(out, zero, 2 * BITS, x.device)
        from . import cuda_build

        lib = cuda_build.load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.lfs_stream_sums_words(x.data_ptr(), x.numel(), acc.data_ptr(),
                                            blocks, zero, stream)
        if err:
            raise RuntimeError(f"stream_sums_words kernel failed: cudaError {err}")
        if x.numel():
            LAUNCHES["words"] += 1
    if out is not None:
        return acc
    both = epilogue_cuda(acc, "words")
    return both[:F.N_BITS], both[F.N_BITS:]


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
    int64, on its device (on a CUDA tensor through the epilogue kernel).
    ``n`` is the true word count for the derived pass total."""
    n = x.numel() if n is None else n
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        acc = torch.empty(2 * BITS, dtype=torch.int64, device=x.device)
        return epilogue_cuda(stream_sums_words_cuda(x, out=acc, zero=True), "words", n)
    return assemble_counters(*stream_sums_words_cuda(x), n)

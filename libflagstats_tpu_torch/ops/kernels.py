"""The bit-sliced flagstat/pospopcnt kernel: CUDA wrapper and plain twin.

Port of the part of ``libflagstats_tpu.ops.pallas_kernels`` that the
main path runs: ``_run_kernel`` in modes ``"flagstat"``,
``"flagstat_report"`` and ``"pospopcnt"`` over raw uint16 words.

* ``stream_sums_cuda(x, mode)`` launches the hand-written sm_90a kernel
  (ops/csrc/flagstat_kernels.cu) on a CUDA tensor, and takes the plain
  version only for a tensor that lies on the CPU. There is no fallback:
  a CUDA tensor the kernel does not take raises.
* ``stream_sums_plain(x, mode)`` is the torch twin of the JAX kernel
  body's jnp twin (``_stream_sums_jnp_body``): the same transpose32,
  transform_planes, stream-input functions, carry-save adders and popcount
  peel, on CPU and CUDA tensors alike.

Both return per-stream sums as (n_streams,) int64 in the stream order of
``bitslice.C_STREAMS + F_STREAMS`` (or the REPORT_* order, or bits 0-15).
"""
from __future__ import annotations

import ctypes

import torch

from .. import flags as F
from . import bitslice as B
from .torch_ops import as_words, assemble_counters

SUB = 8            # sublanes per register tile
LANE = 128         # lanes per register tile
REGS = 32          # int32 registers per transpose group
SUB16 = 2 * SUB    # uint16 sublanes backing one register
GROUP_WORDS = REGS * SUB * LANE * 2   # words per register group (65536)
BODY_WORDS = 8 * GROUP_WORDS          # one Harley-Seal body (8 groups)
#: bodies per chunk of the plain version: 32Mi words, ~0.5 GB of int32
#: intermediates, so 64Mi-word and NA12878-sized inputs fit on the card
PLAIN_CHUNK_BODIES = 64

MODES = ("flagstat", "flagstat_report", "pospopcnt")
_MODE_ID = {m: i for i, m in enumerate(MODES)}   # the .cu's enum Mode
N_STREAMS = {"flagstat": B.N_STREAMS, "flagstat_report": B.N_REPORT_STREAMS,
             "pospopcnt": F.N_BITS}

#: kernel launches per mode, counted where the kernel is launched and
#: nowhere else
LAUNCHES = {m: 0 for m in MODES}


def _check_mode(mode: str) -> None:
    if mode not in _MODE_ID:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


# ---- the plain version: torch twin of _stream_sums_jnp_body ----

def _transpose32(A: list[torch.Tensor], stages: dict[int, list[int]]) -> list[torch.Tensor]:
    """Masked-swap bit transpose of 32 int32 tiles (pallas_kernels._transpose32).

    Each stage mask clears the top j bits, so the arithmetic ``>>`` is
    exact; ``<<`` wraps like uint32."""
    A = list(A)
    for j, mask in B.TRANSPOSE_STAGES:
        for k in stages[j]:
            t = (A[k] ^ (A[k + j] >> j)) & mask
            A[k] = A[k] ^ t
            A[k + j] = A[k + j] ^ (t << j)
    return A


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 tiles holding uint32 bits (SWAR in
    int64, where no step overflows or sign-fills)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _csa(v, a, b):
    """Carry-save full adder: (sum, carry) of v+a+b per bit."""
    va = v ^ a
    return va ^ b, (v & a) | (b & va)


def _stream_inputs_flagstat(rows, report: bool = False):
    """Transposed rows -> the counted (half1, half2) plane pairs, C then F."""
    c_streams = B.REPORT_C_STREAMS if report else B.C_STREAMS
    f_streams = B.REPORT_F_STREAMS if report else B.F_STREAMS
    streams = []
    for row_of in (B.first_half_row, B.second_half_row):
        p = [None if (report and j in (4, 5)) else rows[row_of(j)]
             for j in range(12)]
        t = B.transform_planes(p, report=report)
        q = t[F.FQCFAIL_OFF]
        streams.append([t[k] for k in c_streams] + [t[k] & q for k in f_streams])
    return list(zip(streams[0], streams[1]))


def _stream_inputs_pospopcnt(rows):
    """Transposed rows -> 16 raw positional (half1, half2) plane pairs."""
    return [(rows[B.first_half_row(j)], rows[B.second_half_row(j)])
            for j in range(16)]


def _mode_setup(mode: str):
    if mode == "flagstat":
        return B.pruned_pairs(), _stream_inputs_flagstat
    if mode == "flagstat_report":
        return (B.pruned_pairs(B.REPORT_NEEDED_ROWS),
                lambda rows: _stream_inputs_flagstat(rows, report=True))
    return ({j: B.swap_pairs(j) for j, _ in B.TRANSPOSE_STAGES},
            _stream_inputs_pospopcnt)


def _plain_chunk(xb: torch.Tensor, stages, make_streams, state) -> None:
    """Count one chunk of bodies, (bodies, 8, 32, 16, 128) int16, into
    ``state`` = (v1, v2, v4, v8, acc) lists of (bodies, 8, 128) int32.

    The Pallas kernel runs one Harley-Seal body per grid step and carries
    v1..v8 across steps; here the bodies of a chunk are extra lanes, each
    carrying its own tree from chunk to chunk (counting is order-free)."""
    v1, v2, v4, v8, acc = state
    w = xb.to(torch.int32) & 0xFFFF
    # the kernel's sublane bitcast: adjacent uint16 sublanes pair into one
    # uint32 register, each word intact in one 16-bit field
    regs = w[..., 0::2, :] | (w[..., 1::2, :] << 16)   # (bodies, 8, 32, 8, 128)
    rows = _transpose32([regs[:, :, k] for k in range(REGS)], stages)
    pairs = make_streams(rows)
    for s, (h1, h2) in enumerate(pairs):
        twosA = foursA = eightsA = None
        for g in range(8):
            v1[s], twos = _csa(v1[s], h1[:, g], h2[:, g])
            if g % 2 == 0:
                twosA = twos
                continue
            v2[s], fours = _csa(v2[s], twosA, twos)
            if g % 4 == 1:
                foursA = fours
                continue
            v4[s], eights = _csa(v4[s], foursA, fours)
            if g % 8 == 3:
                eightsA = eights
                continue
            v8[s], sixteens = _csa(v8[s], eightsA, eights)
            acc[s] = acc[s] + (_popcount32(sixteens) << 4)


def stream_sums_plain(x, mode: str = "flagstat") -> torch.Tensor:
    """Per-stream sums of a uint16 word stream -> (n_streams,) int64.

    Pads each chunk with zero words to whole bodies (zero words count
    nothing) and runs on the device the tensor lies on."""
    _check_mode(mode)
    words = as_words(x)
    n_streams = N_STREAMS[mode]
    n = words.numel()
    dev = words.device
    if n == 0:
        return torch.zeros(n_streams, dtype=torch.int64, device=dev)
    stages, make_streams = _mode_setup(mode)
    bodies = min(PLAIN_CHUNK_BODIES, -(-n // BODY_WORDS))
    chunk = bodies * BODY_WORDS
    zero = torch.zeros((bodies, SUB, LANE), dtype=torch.int32, device=dev)
    v1, v2, v4, v8 = ([zero] * n_streams for _ in range(4))
    acc = [zero.to(torch.int64)] * n_streams
    state = (v1, v2, v4, v8, acc)
    for start in range(0, n, chunk):
        part = words[start:start + chunk]
        if part.numel() < chunk:
            part = torch.nn.functional.pad(part, (0, chunk - part.numel()))
        _plain_chunk(part.view(bodies, 8, REGS, SUB16, LANE), stages,
                     make_streams, state)
    out = []
    for s in range(n_streams):
        res = (acc[s] + _popcount32(v1[s]) + (_popcount32(v2[s]) << 1)
               + (_popcount32(v4[s]) << 2) + (_popcount32(v8[s]) << 3))
        out.append(res.sum())
    return torch.stack(out)


# ---- the kernel wrapper ----

def stream_sums_cuda(x: torch.Tensor, mode: str = "flagstat") -> torch.Tensor:
    """Per-stream sums through the CUDA kernel -> (n_streams,) int64.

    ``x``: a contiguous uint16 (or int16 view) tensor. On a CUDA tensor
    this launches the kernel or raises; a CPU tensor takes the plain
    version. The kernel masks its own head and tail, so any 2-byte
    aligned start (an odd-offset slice, say) is taken as it is."""
    _check_mode(mode)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.device.type == "cpu":
        return stream_sums_plain(x, mode)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in (torch.uint16, torch.int16):
        raise ValueError(f"expected uint16 or an int16 view, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the kernel reads a contiguous word stream")
    if x.data_ptr() % 2:
        raise ValueError("the kernel needs 2-byte aligned words")
    out = torch.zeros(N_STREAMS[mode], dtype=torch.int64, device=x.device)
    if x.numel() == 0:
        return out
    from . import cuda_build

    lib = cuda_build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lfs_stream_sums(_MODE_ID[mode], x.data_ptr(), x.numel(),
                                  out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"stream_sums kernel ({mode}) failed: cudaError {err}")
    LAUNCHES[mode] += 1
    return out


def wave_words(mode: str = "flagstat", device=None) -> int:
    """Words one full wave of the kernel's blocks covers on ``device``
    (beyond it the grid-stride loop turns)."""
    _check_mode(mode)
    from . import cuda_build

    lib = cuda_build.load()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.lfs_wave_blocks(_MODE_ID[mode], ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return blocks.value * lib.lfs_words_per_block()


def _sums_to_streams(sums: torch.Tensor, report: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-stream totals -> (C[k], F[k]) scattered into 16-bin vectors
    (pallas_kernels._sums_to_streams)."""
    c_idx = list(B.REPORT_C_STREAMS if report else B.C_STREAMS)
    f_idx = list(B.REPORT_F_STREAMS if report else B.F_STREAMS)
    total = torch.zeros(F.N_BITS, dtype=torch.int64, device=sums.device)
    fail = torch.zeros_like(total)
    total[c_idx] = sums[:len(c_idx)]
    fail[f_idx] = sums[len(c_idx):len(c_idx) + len(f_idx)]
    return total, fail


def flagstat_cuda(x: torch.Tensor, n=None, report: bool = False) -> torch.Tensor:
    """Flagstat counters of a uint16 word tensor -> (32,) int64.

    ``report=True`` counts the 21 report streams and leaves counters
    1, 3, 4, 5 and 17, 19, 20, 21 at 0."""
    sums = stream_sums_cuda(x, "flagstat_report" if report else "flagstat")
    total, fail = _sums_to_streams(sums, report)
    return assemble_counters(total, fail, x.numel() if n is None else n)


def flagstat_cuda_report(x: torch.Tensor, n=None) -> torch.Tensor:
    """The report-counter instantiation of flagstat_cuda."""
    return flagstat_cuda(x, n, report=True)


def pospopcnt_u16_cuda(x: torch.Tensor) -> torch.Tensor:
    """Raw positional popcount of a uint16 word tensor -> (16,) int64."""
    return stream_sums_cuda(x, "pospopcnt")

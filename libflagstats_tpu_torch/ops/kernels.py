"""The bit-sliced flagstat/pospopcnt kernels: CUDA wrappers and plain twins.

Port of the part of ``libflagstats_tpu.ops.pallas_kernels`` that the
ported paths run: ``_run_kernel`` in modes ``"flagstat"``,
``"flagstat_report"`` and ``"pospopcnt"`` over raw uint16 words (K1),
and with ``pre=True`` over host-pretransposed plane tiles, all 32 rows
or the packed 24/20 (K2, ``stream_sums_pallas_pre``).

* ``stream_sums_cuda(x, mode)`` and ``stream_sums_pre_cuda(planes,
  report, packed)`` launch the hand-written sm_90a kernels
  (ops/csrc/flagstat_kernels.cu, ops/csrc/flagstat_pre_kernels.cu) on a
  CUDA tensor, and take the plain version only for a tensor that lies on
  the CPU. There is no fallback: a CUDA tensor a kernel does not take
  raises.
* ``stream_sums_plain(x, mode)`` and ``stream_sums_pre_plain(planes,
  report, packed)`` are the torch twins of the JAX kernel body's jnp twin
  (``_stream_sums_jnp_body``, ``pre=False``/``True``): the same
  transpose32, transform_planes, stream-input functions, carry-save
  adders and popcount peel, on CPU and CUDA tensors alike.

All return per-stream sums as (n_streams,) int64 in the stream order of
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

#: K2's launch counters: flagstat and report mode over plane tiles
PRE_MODES = ("pre", "pre_report")
#: the measurement kernels' launch counters (ops/probe_kernels.py): K4
#: and the three K7 stage probes
PROBES = ("read_xor", "raw", "transpose_xor", "transform_xor")
#: kernel launches per mode, counted where the kernel is launched and
#: nowhere else ("words": K6, ops/words_kernels.py; "fold_xor": K8,
#: ops/probe_kernels.py; "setop": K9, ops/setalgebra.py)
LAUNCHES = {m: 0 for m in MODES + PRE_MODES + ("words",) + PROBES + ("fold_xor", "setop")}

#: packed plane-tile row orders: the flagstat transform never reads the
#: planes of FLAG bits 12-15 (nor, in report mode, of bits 4 and 5), so
#: the pretransposed layout ships only the rows K2 consumes, sorted by
#: original row (pallas_kernels.py:131-143)
PACKED_ROWS_FULL = tuple(sorted(B.NEEDED_ROWS))           # 24 rows
PACKED_ROWS_REPORT = tuple(sorted(B.REPORT_NEEDED_ROWS))  # 20 rows


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
    ``state`` (see _count_rows)."""
    w = xb.to(torch.int32) & 0xFFFF
    # the kernel's sublane bitcast: adjacent uint16 sublanes pair into one
    # uint32 register, each word intact in one 16-bit field
    regs = w[..., 0::2, :] | (w[..., 1::2, :] << 16)   # (bodies, 8, 32, 8, 128)
    rows = _transpose32([regs[:, :, k] for k in range(REGS)], stages)
    _count_rows(rows, make_streams, state)


def _count_rows(rows, make_streams, state) -> None:
    """Count the plane rows of one chunk of bodies, each (bodies, 8, 8,
    128) int32 (None for a row no stream reads), into ``state`` =
    (v1, v2, v4, v8, acc) lists of (bodies, 8, 128) int32.

    The Pallas kernel runs one Harley-Seal body per grid step and carries
    v1..v8 across steps; here the bodies of a chunk are extra lanes, each
    carrying its own tree from chunk to chunk (counting is order-free)."""
    v1, v2, v4, v8, acc = state
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
    state = _new_state(bodies, n_streams, dev)
    for start in range(0, n, chunk):
        part = words[start:start + chunk]
        if part.numel() < chunk:
            part = torch.nn.functional.pad(part, (0, chunk - part.numel()))
        _plain_chunk(part.view(bodies, 8, REGS, SUB16, LANE), stages,
                     make_streams, state)
    return _flush_state(state)


def _new_state(bodies: int, n_streams: int, dev) -> tuple:
    zero = torch.zeros((bodies, SUB, LANE), dtype=torch.int32, device=dev)
    v1, v2, v4, v8 = ([zero] * n_streams for _ in range(4))
    return v1, v2, v4, v8, [zero.to(torch.int64)] * n_streams


def _flush_state(state) -> torch.Tensor:
    """The weighted v1/v2/v4/v8 residuals plus the peeled sums, per
    stream -> (n_streams,) int64."""
    v1, v2, v4, v8, acc = state
    out = []
    for s in range(len(acc)):
        res = (acc[s] + _popcount32(v1[s]) + (_popcount32(v2[s]) << 1)
               + (_popcount32(v4[s]) << 2) + (_popcount32(v8[s]) << 3))
        out.append(res.sum())
    return torch.stack(out)


# ---- the kernel wrapper ----

def check_cuda_words(x) -> bool:
    """True when ``x`` is a tensor on the CPU (the wrappers then take
    their plain versions); False for a word stream a raw-word kernel
    takes; raises for anything else."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in (torch.uint16, torch.int16):
        raise ValueError(f"expected uint16 or an int16 view, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the kernel reads a contiguous word stream")
    if x.data_ptr() % 2:
        raise ValueError("the kernel needs 2-byte aligned words")
    return False


def _check_blocks(blocks) -> int:
    """The launchers' grid argument: 0 (one wave at most) for None."""
    if blocks is None:
        return 0
    if not isinstance(blocks, int) or blocks < 1:
        raise ValueError(f"blocks must be an int >= 1, got {blocks!r}")
    return blocks


def stream_sums_cuda(x: torch.Tensor, mode: str = "flagstat",
                     blocks: int | None = None) -> torch.Tensor:
    """Per-stream sums through the CUDA kernel -> (n_streams,) int64.

    ``x``: a contiguous uint16 (or int16 view) tensor. On a CUDA tensor
    this launches the kernel or raises; a CPU tensor takes the plain
    version. The kernel masks its own head and tail, so any 2-byte
    aligned start (an odd-offset slice, say) is taken as it is.
    ``blocks`` is the most blocks the grid gets, the one geometry knob of
    a kernel whose blocks stride over the input (tools/kernel_sweep.py
    sweeps it); None gives one full wave (``wave_blocks``)."""
    _check_mode(mode)
    blocks = _check_blocks(blocks)
    if check_cuda_words(x):
        return stream_sums_plain(x, mode)
    out = torch.zeros(N_STREAMS[mode], dtype=torch.int64, device=x.device)
    if x.numel() == 0:
        return out
    from . import cuda_build

    lib = cuda_build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lfs_stream_sums(_MODE_ID[mode], x.data_ptr(), x.numel(),
                                  out.data_ptr(), blocks, stream)
    if err:
        raise RuntimeError(f"stream_sums kernel ({mode}) failed: cudaError {err}")
    LAUNCHES[mode] += 1
    return out


def wave_blocks(mode: str = "flagstat", device=None) -> int:
    """Blocks of the kernel resident at once on ``device``: one full
    wave, the default grid's cap."""
    _check_mode(mode)
    from . import cuda_build

    lib = cuda_build.load()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.lfs_wave_blocks(_MODE_ID[mode], ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return blocks.value


def wave_words(mode: str = "flagstat", device=None) -> int:
    """Words one full wave of the kernel's blocks covers on ``device``
    (beyond it the grid-stride loop turns)."""
    from . import cuda_build

    return wave_blocks(mode, device) * cuda_build.load().lfs_words_per_block()


# ---- K2: the kernel over host-pretransposed plane tiles ----

def packed_rows_for(report: bool = False) -> tuple[int, ...]:
    return PACKED_ROWS_REPORT if report else PACKED_ROWS_FULL


def _check_planes(planes, report: bool, packed: bool) -> tuple[torch.Tensor, tuple]:
    """(int32 view of the tiles, their original row order), or raise."""
    if not isinstance(planes, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(planes).__name__}")
    rows = packed_rows_for(report) if packed else tuple(range(REGS))
    if planes.ndim != 4 or tuple(planes.shape[1:]) != (len(rows), SUB, LANE):
        raise ValueError(f"expected (G, {len(rows)}, 8, 128) plane tiles, "
                         f"got {tuple(planes.shape)}")
    if planes.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"expected uint32 plane tiles or an int32 view, got {planes.dtype}")
    return planes.view(torch.int32), rows


def stream_sums_pre_plain(planes: torch.Tensor, report: bool = False,
                          packed: bool = False) -> torch.Tensor:
    """Per-stream sums of plane tiles -> (n_streams,) int64: the torch
    twin of ``_stream_sums_jnp_body(pre=True)`` with the packed-row map
    of ``pallas_kernels._make_kernel`` (``:244-251``).

    ``planes``: (G, R, 8, 128) uint32 (or int32), R = 32, or the packed
    24 (full) / 20 (report) rows of ``packed_rows_for(report)``. Pads
    each chunk with zero tiles to whole 8-group bodies (zero planes
    count nothing) and runs on the device the tensor lies on."""
    planes, rows = _check_planes(planes, report, packed)
    mode = "flagstat_report" if report else "flagstat"
    n_streams = N_STREAMS[mode]
    groups = planes.shape[0]
    if groups == 0:
        return torch.zeros(n_streams, dtype=torch.int64, device=planes.device)
    _, make_streams = _mode_setup(mode)
    slot = {orig: i for i, orig in enumerate(rows)}
    bodies = min(PLAIN_CHUNK_BODIES, -(-groups // 8))
    chunk = bodies * 8
    state = _new_state(bodies, n_streams, planes.device)
    for start in range(0, groups, chunk):
        part = planes[start:start + chunk]
        if part.shape[0] < chunk:
            part = torch.cat([part, part.new_zeros((chunk - part.shape[0],)
                                                   + tuple(part.shape[1:]))])
        xb = part.reshape(bodies, 8, len(rows), SUB, LANE)
        # unshipped rows stay None: the stream builders never read them
        _count_rows([xb[:, :, slot[k]] if k in slot else None for k in range(REGS)],
                    make_streams, state)
    return _flush_state(state)


def stream_sums_pre_cuda(planes: torch.Tensor, report: bool = False,
                         packed: bool = False, blocks: int | None = None) -> torch.Tensor:
    """Per-stream sums of plane tiles through K2 -> (n_streams,) int64.

    ``planes`` as for stream_sums_pre_plain; on a CUDA tensor it must be
    contiguous and 16-byte aligned, and this launches the kernel
    (ops/csrc/flagstat_pre_kernels.cu) or raises. A CPU tensor takes the
    plain version. No group count is padded: a CUDA block takes one
    group per turn of its loop, and zero tiles count nothing. ``blocks``
    as for stream_sums_cuda (one wave: ``pre_wave_groups``)."""
    blocks = _check_blocks(blocks)
    planes32, rows = _check_planes(planes, report, packed)
    if planes.device.type == "cpu":
        return stream_sums_pre_plain(planes, report, packed)
    if planes.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {planes.device}")
    if not planes.is_contiguous():
        raise ValueError("the kernel reads contiguous plane tiles")
    if planes.data_ptr() % 16:
        raise ValueError("the kernel needs 16-byte aligned plane tiles")
    mode = "flagstat_report" if report else "flagstat"
    out = torch.zeros(N_STREAMS[mode], dtype=torch.int64, device=planes.device)
    groups = planes.shape[0]
    if groups == 0:
        return out
    from . import cuda_build

    lib = cuda_build.load()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lfs_stream_sums_pre(_MODE_ID[mode], len(rows), planes32.data_ptr(),
                                      groups, out.data_ptr(), blocks, stream)
    if err:
        raise RuntimeError(f"stream_sums_pre kernel ({mode}, {len(rows)} rows) "
                           f"failed: cudaError {err}")
    LAUNCHES["pre_report" if report else "pre"] += 1
    return out


def pre_wave_groups(report: bool = False, packed: bool = False, device=None) -> int:
    """Groups one full wave of K2's blocks covers on ``device`` (a block
    takes one group per turn of its grid-stride loop)."""
    mode = "flagstat_report" if report else "flagstat"
    rows = len(packed_rows_for(report)) if packed else REGS
    from . import cuda_build

    lib = cuda_build.load()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.lfs_pre_wave_blocks(_MODE_ID[mode], rows, ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return blocks.value


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


def flagstat_cuda_pre(planes: torch.Tensor, n: int, report: bool = False,
                      packed: bool = False) -> torch.Tensor:
    """Flagstat counters over host-pretransposed plane tiles (see
    stream_sums_pre_cuda) -> (32,) int64. ``n`` is the true (pre-padding)
    word count for the derived pass-total (reference: libflagstats.h:429)."""
    sums = stream_sums_pre_cuda(planes, report, packed)
    total, fail = _sums_to_streams(sums, report)
    return assemble_counters(total, fail, n)


def flagstat_cuda_report(x: torch.Tensor, n=None) -> torch.Tensor:
    """The report-counter instantiation of flagstat_cuda."""
    return flagstat_cuda(x, n, report=True)


def pospopcnt_u16_cuda(x: torch.Tensor) -> torch.Tensor:
    """Raw positional popcount of a uint16 word tensor -> (16,) int64."""
    return stream_sums_cuda(x, "pospopcnt")

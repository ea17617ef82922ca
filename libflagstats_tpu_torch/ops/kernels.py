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
Given ``out``, an int64 accumulator, a wrapper adds into it in place
(``zero=True``: the launcher zeroes it first) and returns it, so that a
column's pieces add up on the card with no torch op between launches.

* ``epilogue_cuda(acc, kind, n)`` launches the epilogue kernel
  (ops/csrc/flagstat_epilogue.cu) over such an accumulator: (C[k], F[k])
  or the 32 counters, through the map ``epilogue_map(kind)`` passed by
  value; ``counters_cuda`` reads the counters back into this thread's
  pinned buffer with one wait. ``epilogue_plain`` applies the same map in
  torch: the kernel's twin. On a CPU tensor the paths keep the plain
  versions, ``_sums_to_streams`` and ``torch_ops.assemble_counters``.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .. import flags as F
from ..bench import profiling
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
#: ops/probe_kernels.py; "setop": K9, ops/setalgebra.py; "epilogue": the
#: epilogue kernel, epilogue_cuda)
LAUNCHES = {m: 0 for m in MODES + PRE_MODES + ("words",) + PROBES
            + ("fold_xor", "setop", "epilogue")}

#: the epilogue's kinds of accumulator: K1/K3's (and K2's) stream orders
#: in flagstat and report mode, and K6's pass bits then fail bits
EPILOGUE_KINDS = ("flagstat", "flagstat_report", "words")
#: int64 sums each kind's accumulator holds
RAW_STREAMS = {"flagstat": B.N_STREAMS, "flagstat_report": B.N_REPORT_STREAMS,
               "words": 2 * B.N_PLANES}

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

def launch_span(mode: str, x):
    """The span ``lfs.launch`` of one wrapper call (K1, K2, K6): its
    checks, the output's ``torch.zeros`` and the ctypes launch, or the
    plain version on a CPU tensor; args ``mode`` (a ``LAUNCHES`` key) and
    ``words`` (K2: the words of its plane tiles). None for an empty
    input, which launches nothing."""
    n = x.numel() if isinstance(x, torch.Tensor) else 1
    if not n:
        return profiling.NOOP
    return profiling.span("lfs.launch", mode=mode,
                          words=x.shape[0] * GROUP_WORDS if x.ndim == 4 else n)


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


def accumulator(out, zero: bool, n_sums: int, device: torch.device):
    """(the int64 buffer a launcher adds ``n_sums`` sums into, whether it
    zeroes it first): a new one, zeroed, when ``out`` is None; else
    ``out``, checked, for the launcher to take as it is."""
    if out is None:
        return torch.empty(n_sums, dtype=torch.int64, device=device), True
    if not isinstance(out, torch.Tensor) or out.dtype != torch.int64:
        raise ValueError("out must be an int64 tensor")
    if out.device != device:
        raise ValueError(f"out lies on {out.device}, the input on {device}")
    if out.numel() < n_sums or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous int64 tensor of at least {n_sums} sums")
    return out, bool(zero)


def add_plain(out, sums: torch.Tensor, zero: bool) -> torch.Tensor:
    """The launchers' accumulation on a CPU tensor: ``sums`` as they
    are without ``out``, else copied (``zero``) or added into it."""
    if out is None:
        return sums
    out, zero = accumulator(out, zero, sums.numel(), sums.device)
    if zero:
        out[:sums.numel()] = sums
    else:
        out[:sums.numel()] += sums
    return out


def stream_sums_cuda(x: torch.Tensor, mode: str = "flagstat",
                     blocks: int | None = None, out: torch.Tensor | None = None,
                     zero: bool = False) -> torch.Tensor:
    """Per-stream sums through the CUDA kernel -> (n_streams,) int64.

    ``x``: a contiguous uint16 (or int16 view) tensor. On a CUDA tensor
    this launches the kernel or raises; a CPU tensor takes the plain
    version. The kernel masks its own head and tail, so any 2-byte
    aligned start (an odd-offset slice, say) is taken as it is.
    ``blocks`` is the most blocks the grid gets, the one geometry knob of
    a kernel whose blocks stride over the input (tools/kernel_sweep.py
    sweeps it); None gives one full wave (``wave_blocks``). ``out``: an
    int64 accumulator on ``x``'s device that the sums are added into and
    that is returned (``zero``: zeroed first, by a cudaMemsetAsync in the
    launcher); None gives a new one, zeroed so. An empty ``x`` launches
    no kernel."""
    with launch_span(mode, x):
        _check_mode(mode)
        blocks = _check_blocks(blocks)
        if check_cuda_words(x):
            return add_plain(out, stream_sums_plain(x, mode), zero)
        out, zero = accumulator(out, zero, N_STREAMS[mode], x.device)
        from . import cuda_build

        lib = cuda_build.load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.lfs_stream_sums(_MODE_ID[mode], x.data_ptr(), x.numel(),
                                      out.data_ptr(), blocks, zero, stream)
        if err:
            raise RuntimeError(f"stream_sums kernel ({mode}) failed: cudaError {err}")
        if x.numel():
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
                         packed: bool = False, blocks: int | None = None,
                         out: torch.Tensor | None = None, zero: bool = False) -> torch.Tensor:
    """Per-stream sums of plane tiles through K2 -> (n_streams,) int64.

    ``planes`` as for stream_sums_pre_plain; on a CUDA tensor it must be
    contiguous and 16-byte aligned, and this launches the kernel
    (ops/csrc/flagstat_pre_kernels.cu) or raises. A CPU tensor takes the
    plain version. No group count is padded: a CUDA block takes one
    group per turn of its loop, and zero tiles count nothing. ``blocks``
    as for stream_sums_cuda (one wave: ``pre_wave_groups``), and ``out``
    and ``zero`` too."""
    with launch_span("pre_report" if report else "pre", planes):
        blocks = _check_blocks(blocks)
        planes32, rows = _check_planes(planes, report, packed)
        if planes.device.type == "cpu":
            return add_plain(out, stream_sums_pre_plain(planes, report, packed), zero)
        if planes.device.type != "cuda":
            raise ValueError(f"the kernel runs on CUDA tensors, got {planes.device}")
        if not planes.is_contiguous():
            raise ValueError("the kernel reads contiguous plane tiles")
        if planes.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned plane tiles")
        mode = "flagstat_report" if report else "flagstat"
        out, zero = accumulator(out, zero, N_STREAMS[mode], planes.device)
        groups = planes.shape[0]
        from . import cuda_build

        lib = cuda_build.load()
        with torch.cuda.device(planes.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.lfs_stream_sums_pre(_MODE_ID[mode], len(rows), planes32.data_ptr(),
                                          groups, out.data_ptr(), blocks, zero, stream)
        if err:
            raise RuntimeError(f"stream_sums_pre kernel ({mode}, {len(rows)} rows) "
                               f"failed: cudaError {err}")
        if groups:
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


# ---- the epilogue: an accumulator's sums -> (C[k], F[k]) or the 32 counters

def epilogue_map(kind: str) -> tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]:
    """(c, c2, f) of one kind of accumulator (``EPILOGUE_KINDS``), from
    bitslice's stream orders: for each FLAG bit k, C[k] = acc[c[k]] +
    acc[c2[k]] and F[k] = acc[f[k]], an index of -1 reading 0. K1, K3
    and K2 hold C then F in ``C_STREAMS + F_STREAMS`` (or the REPORT_*)
    order; K6 holds the pass bits 0-14 then the fail bits 0-14, so C[k]
    is their sum."""
    c, c2, f = [-1] * F.N_BITS, [-1] * F.N_BITS, [-1] * F.N_BITS
    if kind == "words":
        for k in range(B.N_PLANES):
            c[k], c2[k], f[k] = k, B.N_PLANES + k, B.N_PLANES + k
    elif kind in ("flagstat", "flagstat_report"):
        report = kind == "flagstat_report"
        c_streams = B.REPORT_C_STREAMS if report else B.C_STREAMS
        f_streams = B.REPORT_F_STREAMS if report else B.F_STREAMS
        for i, k in enumerate(c_streams):
            c[k] = i
        for j, k in enumerate(f_streams):
            f[k] = len(c_streams) + j
    else:
        raise ValueError(f"unknown epilogue kind {kind!r}; expected one of {EPILOGUE_KINDS}")
    return tuple(c), tuple(c2), tuple(f)


def epilogue_plain(acc: torch.Tensor, kind: str, n=None) -> torch.Tensor:
    """The epilogue kernel's arithmetic in torch, on the map it is given
    -> (32,) int64: (C[16], F[16]) of ``acc``, or with ``n`` the 32
    counters of n words (pass[k] = C[k] - F[k], fail[k] = F[k]; at the
    QC-fail bit n - C and C)."""
    c, c2, f = epilogue_map(kind)
    a = torch.cat([acc.to(torch.int64).reshape(-1)[:RAW_STREAMS[kind]],
                   acc.new_zeros(1, dtype=torch.int64)])   # index -1 reads this 0
    total = a[list(c)] + a[list(c2)]
    fail = a[list(f)]
    if n is None:
        return torch.cat([total, fail])
    q = F.FQCFAIL_OFF
    passed = total - fail
    passed[q] = int(n) - total[q]
    failed = fail.clone()
    failed[q] = total[q]
    return torch.cat([passed, failed])


_MAP_ARGS: dict = {}


def _map_arg(kind: str):
    """The ctypes ``EpilogueMap`` of ``kind``, built once."""
    arg = _MAP_ARGS.get(kind)
    if arg is None:
        from .cuda_build import EpilogueMap

        row = ctypes.c_int8 * F.N_BITS
        arg = _MAP_ARGS[kind] = EpilogueMap(*(row(*m) for m in epilogue_map(kind)),
                                            F.FQCFAIL_OFF)
    return arg


def epilogue_cuda(acc: torch.Tensor, kind: str, n=None, out: torch.Tensor | None = None,
                  host: torch.Tensor | None = None, done=None) -> torch.Tensor:
    """Enqueue the epilogue kernel over a card accumulator -> ``out``,
    (32,) int64 on its device (a new one when None): (C[16], F[16]) of
    ``acc``, or with ``n`` the 32 counters of n words. ``host`` (pinned
    int64[32]) gets a copy of ``out``, and ``done`` (a torch.cuda.Event
    created on the device) is recorded after it. One launch
    (``LAUNCHES["epilogue"]``), no wait; span ``lfs.assemble``."""
    with profiling.span("lfs.assemble"):
        if acc.device.type != "cuda" or acc.dtype != torch.int64 or not acc.is_contiguous():
            raise ValueError("the epilogue reads a contiguous int64 accumulator on a "
                             f"CUDA device, got {acc.dtype} on {acc.device}")
        if acc.numel() < RAW_STREAMS[kind]:
            raise ValueError(f"a {kind} accumulator holds {RAW_STREAMS[kind]} sums, "
                             f"got {acc.numel()}")
        out, _ = accumulator(out, False, F.N_COUNTERS, acc.device)
        from . import cuda_build

        lib = cuda_build.load()
        with torch.cuda.device(acc.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.lfs_epilogue(acc.data_ptr(), out.data_ptr(), _map_arg(kind),
                                   0 if n is None else int(n), n is not None,
                                   None if host is None else host.data_ptr(),
                                   None if done is None else done.cuda_event, stream)
        if err:
            raise RuntimeError(f"epilogue kernel ({kind}) failed: cudaError {err}")
        LAUNCHES["epilogue"] += 1
        return out


class _Scratch:
    """One thread's buffers for counts read back from one card: the
    accumulator of its one-shot counts and the epilogue's output on the
    card, the pinned int64[32] the counters are copied into, and the
    event recorded after that copy. A call waits on the event and reads
    the buffer before it returns, so a thread's uses never overlap, and
    no two threads share one."""

    def __init__(self, dev: torch.device):
        self.acc = torch.empty(max(RAW_STREAMS.values()), dtype=torch.int64, device=dev)
        self.out = torch.empty(F.N_COUNTERS, dtype=torch.int64, device=dev)
        self.host = torch.empty(F.N_COUNTERS, dtype=torch.int64, pin_memory=True)
        self.host_np = self.host.numpy()
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(dev))   # made on dev


_LOCAL = threading.local()


def scratch(dev: torch.device) -> _Scratch:
    """This thread's ``_Scratch`` for the CUDA device ``dev``, made at
    its first use."""
    by_dev = getattr(_LOCAL, "by_dev", None)
    if by_dev is None:
        by_dev = _LOCAL.by_dev = {}
    s = by_dev.get(dev)
    if s is None:
        s = by_dev[dev] = _Scratch(dev)
    return s


def counters_cuda(acc: torch.Tensor, kind: str, n, timer=None) -> np.ndarray:
    """The 32 counters of ``n`` words from a card accumulator, on the
    host -> (32,) uint64: the epilogue (span ``lfs.assemble``), its copy
    into this thread's pinned buffer, and one wait, on the event after
    it (span ``lfs.readback``; ``timer``'s section ``final_sync``)."""
    s = scratch(acc.device)
    epilogue_cuda(acc, kind, n, s.out, s.host, s.done)
    with profiling.span("lfs.readback", timer, "final_sync"):
        s.done.synchronize()
        return s.host_np.astype(np.uint64)


def host_counts(t: torch.Tensor, timer=None) -> np.ndarray:
    """Counts of a plain path on the host, uint64 (span ``lfs.readback``;
    ``timer``'s section ``final_sync``): waits for the device."""
    with profiling.span("lfs.readback", timer, "final_sync"):
        return t.cpu().numpy().astype(np.uint64)


def flagstat_cuda(x: torch.Tensor, n=None, report: bool = False) -> torch.Tensor:
    """Flagstat counters of a uint16 word tensor -> (32,) int64, on its
    device: on a CUDA tensor K1 (K3) and the epilogue kernel, on a CPU
    tensor the plain versions.

    ``report=True`` counts the 21 report streams and leaves counters
    1, 3, 4, 5 and 17, 19, 20, 21 at 0."""
    mode = "flagstat_report" if report else "flagstat"
    sums = stream_sums_cuda(x, mode)
    n = x.numel() if n is None else n
    if sums.device.type == "cuda":
        return epilogue_cuda(sums, mode, n)
    return assemble_counters(*_sums_to_streams(sums, report), n)


def flagstat_cuda_pre(planes: torch.Tensor, n: int, report: bool = False,
                      packed: bool = False) -> torch.Tensor:
    """Flagstat counters over host-pretransposed plane tiles (see
    stream_sums_pre_cuda) -> (32,) int64, as flagstat_cuda. ``n`` is the
    true (pre-padding) word count for the derived pass-total (reference:
    libflagstats.h:429)."""
    sums = stream_sums_pre_cuda(planes, report, packed)
    if sums.device.type == "cuda":
        return epilogue_cuda(sums, "flagstat_report" if report else "flagstat", n)
    return assemble_counters(*_sums_to_streams(sums, report), n)


def flagstat_cuda_report(x: torch.Tensor, n=None) -> torch.Tensor:
    """The report-counter instantiation of flagstat_cuda."""
    return flagstat_cuda(x, n, report=True)


def pospopcnt_u16_cuda(x: torch.Tensor) -> torch.Tensor:
    """Raw positional popcount of a uint16 word tensor -> (16,) int64."""
    return stream_sums_cuda(x, "pospopcnt")

"""Size-tiered dispatch: the one-call entry points of the port.

The counterpart of ``libflagstats_tpu.ops.dispatch`` (itself the
counterpart of FLAGSTATS_get_function / FLAGSTATS_u16, reference:
libflagstats.h:2977-3070). The backend probe is
``torch.cuda.is_available()``, and the tiers are

  ``device="cpu"``                        -> the plain torch tier on the CPU
  a CUDA device present, or asked for     -> the bit-sliced CUDA kernel, at
                                             every size (n = 0 launches nothing)
  no CUDA device, and no request for the CPU -> RuntimeError

The host tiers (``"numpy"``, ``"native"``) are chosen by name: a call
on the card never moves to the host. Nor does it move to another card
tier by size: on an H100, with host columns staged, no card tier beat
``"cuda"``'s wall from a swept size to the end of 2^10-2^28 words
(``tools/crossover_sweep``; PERF.md). The one size tier
is that of a call that asked for the CPU: below ``TORCH_MIN_CPU`` words
it gets ``"numpy"`` (the counterpart of the JAX package's
``XLA_MIN_CPU``). Its default, 0, keeps the torch tier at every size;
``tools/crossover_sweep --device cpu --write`` measures the crossover
into the port's calibration file (``calibration.py``), which
``_apply_calibration()`` reads at import. A call on the card never
reads a threshold. ``device_impl`` is the device tier alone, for the
paths that need one (the sharded and multihost counts, the stream, set
algebra) and as the guard of the file readers.

No shape bucketing: the TPU path padded to a ladder of shapes to bound
XLA recompiles, and a CUDA kernel does not recompile per shape. The
kernel masks its own ragged edge, so nothing is padded on the host.

A kernel tier given a host column (a numpy array or a CPU tensor)
counts it through ``ops/staging.py``: pieces of ``STAGE_WORDS`` words
copied into pinned slots (a column already pinned ships from its own
memory), shipped on a side stream and counted one launch a piece, the
sums accumulating in place on the device (on the CPU the same loop runs
the plain versions). Words already on a card are
counted where they lie; ``"torch"`` and ``"torch_matmul"`` copy a column
whole. On a card a kernel tier's count ends in the epilogue kernel,
which writes the 32 counters, a copy of them into a pinned host buffer
and one wait (``staging.Tally``). A ``"cuda"`` or ``"cuda_report"``
count that is one piece (words on a card within DEVICE_WORD_CAP, or a
host column within one staged piece) is enqueued whole by one native
call and waited on once (``_one_call``); any other count takes the
general path above.

``impl="native"`` (the host AVX2 kernels of the native library),
``impl="cuda_pre"`` (host packed bit transpose, then the plane-tile
kernel), ``impl="cuda_words"`` (the word-space kernel K6) and, for
``pospopcnt_u16``, ``impl="torch_matmul"`` (an int8 ones-matrix product
on the tensor cores) are chosen by name only.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import flags as F
from ..bench import profiling
from ..oracle import flagstat_numpy
from . import kernels as K
from . import native_host
from . import staging as ST
from .kernels import host_counts, pospopcnt_u16_cuda
from .staging import Tally, stage, staged_sums
from .torch_ops import as_words, flagstat_torch, pospopcnt_u16_matmul, pospopcnt_u16_torch

#: implementation registry
FLAGSTAT_IMPLS = {
    "numpy": "host vectorized mask-select oracle (FLAGSTAT_scalar tier)",
    "native": "host AVX2 Harley-Seal kernel (native C++ library)",
    "torch": "packed-SWAR word transform + positional reduce in plain torch, "
             "on any device",
    "cuda": "bit-sliced register transpose + popcount CUDA kernel (sm_90a)",
    "cuda_report": "the same kernel counting the 21 report streams only "
                   "(masked-positional counters are 0)",
    "cuda_pre": "host packed bit transpose (native C++), then the "
                "transform + popcount CUDA kernel over 24-row plane tiles "
                "(sm_90a)",
    "cuda_words": "word-space CUDA kernel, no bit transpose: shared-memory "
                  "transform table + one two-level Harley-Seal tree over "
                  "pass|fail lanes (sm_90a)",
}
POSPOPCNT_IMPLS = {
    "numpy": "host per-bit count",
    "native": "host AVX2 Harley-Seal kernel (native C++ library)",
    "torch": "packed-SWAR shift-mask-reduce in plain torch",
    "cuda": "bit-sliced register transpose + popcount CUDA kernel (sm_90a)",
    "torch_matmul": "int8 bit expansion + a ones-matrix product on the tensor cores "
                    "(torch._int_mm, int32 accumulation)",
}

#: the chunk of words ``"torch_matmul"`` expands and reduces per step:
#: 64 MiB of int8 bits, 16 steps for 64Mi words (the JAX default, 1 << 17,
#: would be 512 steps of 6 device launches each)
MATMUL_CHUNK = 1 << 22

#: one device call counts at most this many words; the entry points split
#: longer streams into accumulating sub-calls. Exact by the block-
#: accumulative contract (reference: benchmark/flagstats.cpp:311-332):
#: counter 9 is derived per chunk as chunk_len - chunk_fail. It bounds
#: one call's device buffer and keeps every per-thread 32-bit tally of
#: the kernel far from wrapping. Module-level so tests can monkeypatch it.
DEVICE_WORD_CAP = 0x7FFFFFFF

#: ``flagstats_u16`` calls counted in one native call (``_one_call``)
ONE_CALL = {"calls": 0}

#: below this many words a call that asked for the CPU counts with
#: ``"numpy"``, from it with ``"torch"`` (0: torch at every size until a
#: calibration file says otherwise; calibration.py)
TORCH_MIN_CPU = 0
#: the same for ``pospopcnt_u16``
POSPOPCNT_TORCH_MIN_CPU = 0


def _apply_calibration() -> list[str]:
    """Override the thresholds above from the port's calibration file
    (written by ``tools/crossover_sweep --device cpu --write``; schema in
    calibration.py). Returns the names applied. Runs at import; call
    again after the file changed."""
    from ..calibration import load_thresholds

    applied = []
    for name, value in load_thresholds().items():
        globals()[name] = value
        applied.append(name)
    return applied


_CALIBRATED = _apply_calibration()


def device_impl(device=None) -> str:
    """The device tier: ``"torch"`` when ``device`` is the CPU, else
    ``"cuda"``. With no CUDA device and no ``device`` asked for, raises:
    the entry points count on the card unless the caller asks for the
    CPU."""
    if device is not None:
        return "torch" if torch.device(device).type == "cpu" else "cuda"
    if torch.cuda.is_available():
        return "cuda"
    raise RuntimeError(
        "no CUDA device is available; ask for the CPU with device='cpu' "
        "(the plain torch tier) or for a host impl by name (impl='native', "
        "or impl='numpy' for a column in memory)")


def auto_impl(n_len: int, device=None) -> str:
    """The flagstat tier for one call of ``n_len`` words: ``"cuda"`` at
    every size on the card; on the CPU (``device="cpu"``) ``"numpy"``
    below ``TORCH_MIN_CPU`` words, else ``"torch"``. Raises as
    ``device_impl`` does."""
    impl = device_impl(device)
    return "numpy" if impl == "torch" and n_len < TORCH_MIN_CPU else impl


def pospopcnt_auto_impl(n_len: int, device=None) -> str:
    """The pospopcnt tier for one call of ``n_len`` words (the flagstat
    rule, with ``POSPOPCNT_TORCH_MIN_CPU``)."""
    impl = device_impl(device)
    return "numpy" if impl == "torch" and n_len < POSPOPCNT_TORCH_MIN_CPU else impl


def _target_device(impl: str, device, words: torch.Tensor) -> torch.device:
    """Where a device tier computes: ``device`` if given; else the
    words' own device for "torch" or for words already on a CUDA device;
    else the CUDA device (so "torch_matmul", like the kernel tiers,
    counts on the card unless asked for the CPU). Raises when that is a
    CUDA device and none is available: the kernel tiers never fall back
    to the plain version."""
    if device is None:
        device = words.device if impl == "torch" or words.device.type == "cuda" \
            else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"impl {impl!r} was asked to count on {device}, "
                           "and no CUDA device is available")
    return device


def _host_words(words) -> np.ndarray:
    if isinstance(words, torch.Tensor):
        return words.cpu().numpy().view(np.uint16)
    return words


def get_function(n_len: int, impl: str | None = None, device=None):
    """A callable (uint16 words: numpy array or tensor) -> (32,) uint64
    counters for streams of length ``n_len`` (reference:
    FLAGSTATS_get_function, libflagstats.h:2977)."""
    if impl is None:
        impl = auto_impl(n_len, device)
    if impl == "numpy":
        return lambda arr: flagstat_numpy(_host_words(_validate_u16(arr)))
    if impl == "native":
        return lambda arr: native_host.flagstat_native(_host_words(_validate_u16(arr)))
    if impl not in FLAGSTAT_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")

    def run(arr):
        words = as_words(_validate_u16(arr))
        target = _target_device(impl, device, words)
        if impl == "torch":
            return host_counts(flagstat_torch(words.to(target)))
        kind, report = ("cuda", True) if impl == "cuda_report" else (impl, False)
        tally = Tally(kind, target, report, scratch=True)
        if impl == "cuda_pre" or words.device.type == "cpu":
            # a host column, in pinned pieces; cuda_pre transposes each
            # into packed tiles on the host: 25% fewer bytes cross the bus
            # and are read than raw words (dispatch.py:283-300 of the JAX
            # package)
            stage([(words.cpu(), tally)])
        else:
            tally.add(words.to(target))
        return tally.counters(words.numel())

    return run


def _device_chunks(words, granule: int = 8):
    """Views of ``words`` within DEVICE_WORD_CAP each; the chunk step is a
    multiple of ``granule`` words, so a 16-byte aligned stream stays
    16-byte aligned in every chunk."""
    n = len(words)
    if n <= DEVICE_WORD_CAP:
        yield words
        return
    step = max(DEVICE_WORD_CAP // granule, 1) * granule
    for start in range(0, n, step):
        yield words[start:start + step]


def _validate_u16(array):
    """The words of ``array`` as a flat uint16 numpy array, or, for a
    tensor, as a flat contiguous int16 view on its own device."""
    if isinstance(array, torch.Tensor):
        return as_words(array if array.is_contiguous() else array.contiguous())
    arr = np.asarray(array)
    if arr.dtype != np.uint16:
        # allow lossless integer input; reject anything that would be a
        # silent value-mangling cast
        if arr.dtype.kind not in "ui" or (arr.size and
                                          (arr.min() < 0 or arr.max() > 0xFFFF)):
            raise ValueError(
                f"FLAG array must be uint16 (or losslessly convertible), "
                f"got {arr.dtype}"
            )
        arr = arr.astype(np.uint16)
    return np.ascontiguousarray(arr).ravel()


def _held(words) -> torch.device | None:
    """The CUDA device validated ``words`` lie on, or None."""
    if isinstance(words, torch.Tensor):
        dev = words.device
        if dev.type == "cuda":
            return dev
    return None


def _where(words, device):
    """The device asked for: ``device``, or that of words already on a
    CUDA device. Words on the CPU are no request for the CPU."""
    return device if device is not None else _held(words)


def _card(device) -> torch.device | None:
    """The CUDA device, with its index, that ``device`` names (None: the
    current one), or None when it names none or no card is present."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
    if not torch.cuda.is_available():
        return None
    if device is None or device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _one_call(n: int, held, impl: str, device) -> torch.device | None:
    """The CUDA device on which a count of ``n`` words is one native
    call, or None for the general path. It is one call when the impl is
    ``"cuda"`` or ``"cuda_report"`` and the count is one piece: words
    lying on the card ``held`` (the one named, if any), at most
    DEVICE_WORD_CAP of them; or a host column (``held`` None: numpy or a
    CPU tensor) of at most STAGE_WORDS words (and DEVICE_WORD_CAP) for a
    card."""
    if impl != "cuda" and impl != "cuda_report":
        return None
    if held is not None:
        if n > DEVICE_WORD_CAP or (device is not None and _card(device) != held):
            return None
        return held
    if n > min(ST.STAGE_WORDS, DEVICE_WORD_CAP):
        return None
    return _card(device)


def flagstats_u16(array, out=None, impl: str | None = None, device=None) -> np.ndarray:
    """Count flagstat statistics of a uint16 FLAG column -> (32,) uint64.

    ``array``: a numpy array or a torch tensor (uint16, or its int16
    view). Accumulates into ``out`` when given (reference: FLAGSTATS_u16,
    libflagstats.h:3025). ``device`` picks where a device tier computes.
    Streams past DEVICE_WORD_CAP are split into accumulating sub-calls,
    each with its own true length for the derived pass total. A count of
    one piece on a card (``_one_call``) is one native call
    (``kernels.flagstat_count``; a host column through a ring slot,
    ``staging.count_piece``), counted in ``ONE_CALL``. Span
    ``lfs.flagstats_u16``, args words, impl and held (``card`` for words
    on a CUDA device, else ``host``)."""
    with profiling.span("lfs.flagstats_u16") as call:
        words = _validate_u16(array)
        n = len(words)
        held = _held(words)
        if impl is None:
            impl = auto_impl(n, held if device is None else device)
        call.note(words=n, impl=impl, held="host" if held is None else "card")
        card = _one_call(n, held, impl, device)
        if card is not None:
            ONE_CALL["calls"] += 1
            mode = "flagstat_report" if impl == "cuda_report" else "flagstat"
            if held is not None:
                counts = K.flagstat_count(card, mode, words.data_ptr(), n)
            else:
                counts = ST.count_piece(as_words(words), card, mode)
            if out is None:
                return counts
            out += counts
            return out
        fn = get_function(len(words), impl, device)
        acc = np.zeros(F.N_COUNTERS, dtype=np.uint64) if out is None else out
        host_tier = impl in ("numpy", "native")
        for chunk in ([words] if host_tier else _device_chunks(words)):
            acc += fn(chunk)
        return acc


def pospopcnt_u16(array, impl: str | None = None, device=None) -> np.ndarray:
    """Positional popcount of a uint16 array -> (16,) uint64
    (reference: STORM_pospopcnt_u16, libalgebra.h:3497)."""
    words = _validate_u16(array)
    if impl is None:
        impl = pospopcnt_auto_impl(len(words), _where(words, device))
    if impl not in POSPOPCNT_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "numpy":
        x = _host_words(words).astype(np.uint32)
        return np.array([np.count_nonzero((x >> k) & 1) for k in range(F.N_BITS)],
                        dtype=np.uint64)
    if impl == "native":
        return native_host.pospopcnt_native(_host_words(words))
    fn = {"torch": pospopcnt_u16_torch, "cuda": pospopcnt_u16_cuda,
          "torch_matmul": lambda w: pospopcnt_u16_matmul(w, chunk=MATMUL_CHUNK)}[impl]
    acc = np.zeros(F.N_BITS, dtype=np.uint64)
    for chunk in _device_chunks(words):
        w = as_words(chunk)
        target = _target_device(impl, device, w)
        if impl == "cuda" and w.device.type == "cpu":
            acc += host_counts(staged_sums([(w, target)], "pospopcnt")[0])
        else:
            acc += host_counts(fn(w.to(target)))
    return acc

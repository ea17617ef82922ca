"""Set-algebra population counts over bitmaps.

The port of ``libflagstats_tpu.ops.setalgebra``: parity with the
libalgebra layer the reference vendors (STORM_intersect_count /
STORM_union_count / STORM_diff_count and plain popcount, reference:
python/libalgebra.h:500-3398). The JAX package's device tier is
``lax.population_count`` + ``sum`` on uint32 lanes, fused by XLA into
one pass. PyTorch has no popcount operator, so the card's tier is a
small hand-written kernel (K9, ops/csrc/setalgebra_kernels.cu: one
``__popc`` per lane, bound by the read of the bitmaps).

* ``setop_count_cuda(a, b, op)`` launches K9 on CUDA tensors, counts the
  launch in ``kernels.LAUNCHES["setop"]``, and takes the plain version
  only for tensors on the CPU. CUDA tensors the kernel does not take
  raise; there is no fallback.
* ``setop_count_plain(a, b, op)`` computes the same count in torch, on
  CPU and CUDA tensors alike: int32 lanes, a SWAR popcount in int64.
* ``popcnt``, ``intersect_count``, ``union_count`` and ``diff_count``
  are the public functions: numpy arrays as in the JAX package, or torch
  tensors, so a bitmap may already lie on the card; each returns a
  Python int.

The tallies are int64 (the kernel's are 64 bits from the thread up), so
nothing wraps at 2^31 set bits and the JAX package's cut into chunks of
``_CHUNK_LANES`` lanes (there because its int32 reduce went negative) is
not carried over.

Impl names: ``"cuda"`` (K9), ``"torch"`` (the plain version),
``"native"`` (the host library's POPCNT loop). The default is the
port's rule for every entry point: the card at every size;
``device="cpu"`` gives ``"torch"``; with no card and no ``device`` the
functions raise. (The JAX package prefers ``"native"`` when the library
builds.)
"""
from __future__ import annotations

import numpy as np
import torch

from . import dispatch as D
from . import native_host
from .kernels import LAUNCHES, _popcount32

SETOP_IMPLS = ("cuda", "torch", "native")
#: lanes per pass of the plain version (64 MiB of input, ~0.5 GB of
#: int64 intermediates)
PLAIN_CHUNK_LANES = 1 << 24


def _check_op(op: str, b) -> None:
    if op not in native_host.SETOP_IDS:
        raise ValueError(f"unknown op {op!r}; expected one of {tuple(native_host.SETOP_IDS)}")
    if (b is None) != (op == "popcnt"):
        raise ValueError(f"op {op!r} takes {'one bitmap' if op == 'popcnt' else 'two bitmaps'}")


def _check_lanes(t, name: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a flat contiguous int32 tensor (uint32 lanes), "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check_pair(a, b, op: str) -> None:
    _check_op(op, b)
    _check_lanes(a, "a")
    if b is not None:
        _check_lanes(b, "b")
        if b.numel() != a.numel():
            raise ValueError("bitmaps must have equal size")
        if b.device != a.device:
            raise ValueError(f"bitmaps must lie on one device, got {a.device} and {b.device}")


def _combine(a: torch.Tensor, b, op: str) -> torch.Tensor:
    if op == "intersect":
        return a & b
    if op == "union":
        return a | b
    if op == "diff":
        return a & ~b
    return a


def setop_count_plain(a: torch.Tensor, b, op: str) -> torch.Tensor:
    """sum(popcount(f(a, b))) over int32 lanes holding uint32 bits ->
    (1,) int64, on the device the tensors lie on. ``op``: "intersect"
    (a & b), "union" (a | b), "diff" (a & ~b), or "popcnt" (a; ``b`` is
    None)."""
    _check_pair(a, b, op)
    total = torch.zeros(1, dtype=torch.int64, device=a.device)
    for start in range(0, a.numel(), PLAIN_CHUNK_LANES):
        stop = start + PLAIN_CHUNK_LANES
        part = _combine(a[start:stop], None if b is None else b[start:stop], op)
        total += _popcount32(part).sum()
    return total


def setop_count_cuda(a: torch.Tensor, b, op: str) -> torch.Tensor:
    """The count (see setop_count_plain) through the CUDA kernel -> (1,)
    int64. Tensors on the CPU take the plain version; CUDA tensors launch
    the kernel or raise. The lanes may start at any 4-byte aligned
    address; 0 lanes launch nothing."""
    _check_pair(a, b, op)
    if a.device.type == "cpu":
        return setop_count_plain(a, b, op)
    if a.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {a.device}")
    out = torch.zeros(1, dtype=torch.int64, device=a.device)
    if a.numel():
        from . import cuda_build

        lib = cuda_build.load()
        with torch.cuda.device(a.device):
            err = lib.lfs_setop_count_cuda(
                native_host.SETOP_IDS[op], a.data_ptr(), None if b is None else b.data_ptr(),
                a.numel(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"setop_count kernel ({op}) failed: cudaError {err}")
        LAUNCHES["setop"] += 1
    return out


# ---- the public functions ----

def _as_u32(x) -> np.ndarray:
    """View any integer bitmap array as a flat uint32 buffer."""
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype.kind not in "ui":
        raise ValueError(f"bitmap array must be integer-typed, got {arr.dtype}")
    if arr.nbytes % 4:
        raise ValueError("bitmap byte size must be a multiple of 4")
    return arr.view(np.uint32).ravel()


def _as_lanes(x) -> torch.Tensor:
    """Any integer bitmap, a numpy array or a torch tensor, as a flat
    int32 tensor of its bytes, on the device it lies on (no copy for a
    contiguous input)."""
    if not isinstance(x, torch.Tensor):
        return torch.from_numpy(_as_u32(x).view(np.int32))
    if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
        raise ValueError(f"bitmap tensor must be integer-typed, got {x.dtype}")
    if x.numel() * x.element_size() % 4:
        raise ValueError("bitmap byte size must be a multiple of 4")
    flat = x.contiguous().reshape(-1)
    if flat.data_ptr() % 4:
        raise ValueError("bitmap tensor must start at a 4-byte aligned address")
    return flat.view(torch.uint8).view(torch.int32)


def _count(a, b, op: str, impl: str | None, device) -> int:
    lanes = [_as_lanes(a)] + ([] if b is None else [_as_lanes(b)])
    if b is not None and lanes[0].numel() != lanes[1].numel():
        raise ValueError("bitmaps must have equal size")
    if impl is None:
        impl = D.device_impl(D._where(lanes[0], device))
    if impl not in SETOP_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {SETOP_IMPLS}")
    if lanes[0].numel() == 0:
        return 0
    if impl == "native":
        host = [t.cpu().numpy().view(np.uint32) for t in lanes]
        return native_host.setop_count_native(host[0], host[1] if b is not None else None, op)
    target = D._target_device(impl, device, lanes[0])
    lanes = [t.to(target) for t in lanes]
    fn = setop_count_plain if impl == "torch" else setop_count_cuda
    return int(fn(lanes[0], lanes[1] if b is not None else None, op))


def popcnt(bitmap, impl: str | None = None, device=None) -> int:
    """Total set bits (reference: STORM_popcnt, libalgebra.h). Exact for
    any size."""
    return _count(bitmap, None, "popcnt", impl, device)


def intersect_count(a, b, impl: str | None = None, device=None) -> int:
    """popcount(a & b) (reference: STORM_intersect_count)."""
    return _count(a, b, "intersect", impl, device)


def union_count(a, b, impl: str | None = None, device=None) -> int:
    """popcount(a | b) (reference: STORM_union_count)."""
    return _count(a, b, "union", impl, device)


def diff_count(a, b, impl: str | None = None, device=None) -> int:
    """popcount(a & ~b) (reference: STORM_diff_count)."""
    return _count(a, b, "diff", impl, device)

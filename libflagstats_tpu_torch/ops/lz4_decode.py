"""The framed stream's LZ4 decode on the card: CUDA wrapper and plain version.

Replaces no TPU kernel: the JAX stream decodes its frames on the host.
The device stream (``io/stream.py``) ships an LZ4 file's compressed
bytes to the card and decodes hundreds of frames in one launch
(ops/csrc/lz4_decode.cu, one warp a frame), so that the host's part of a
run is a copy.

A frame table (int64, one row ``(src, len, out, raw)`` a frame) says
where each frame's compressed bytes lie in ``comp`` (at ``src -
comp_shift``, ``len`` bytes), where its output goes in ``out`` (at ``out
- out_shift`` bytes, ``raw`` bytes) and, at the row's index in
``status``, what it decoded: the bytes decoded, or -1.

* ``decode_frames`` launches the kernel on CUDA tensors and takes the
  plain version only for tensors on the CPU. There is no fallback: CUDA
  tensors the kernel does not take raise.
* ``decode_frames_plain`` walks the same table frame by frame with
  ``codec.decompress_block`` and writes the same words; a frame it
  rejects gets -1, one it decodes its raw length.
"""
from __future__ import annotations

import torch

from ..bench import profiling
from ..io import codec as C
from .kernels import launch

#: the table's columns
SRC, LEN, OUT, RAW = range(4)


def _check(comp, table, first: int, count: int, out, status) -> None:
    if comp.dtype != torch.uint8 or out.dtype != torch.uint8:
        raise ValueError(f"comp and out are uint8 byte views, got {comp.dtype}, {out.dtype}")
    if table.dtype != torch.int64 or table.ndim != 2 or table.shape[1] != 4:
        raise ValueError(f"the frame table is int64 (frames, 4), got {table.dtype} "
                         f"{tuple(table.shape)}")
    if status.dtype != torch.int32 or status.numel() < table.shape[0]:
        raise ValueError("status is int32, one entry a row of the table")
    if not 0 <= first <= first + count <= table.shape[0]:
        raise ValueError(f"frames [{first}, {first + count}) outside a table of "
                         f"{table.shape[0]} rows")
    devices = {t.device for t in (comp, table, out, status)}
    if len(devices) != 1:
        raise ValueError(f"the decode's tensors lie on one device, got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (comp, table, out, status)):
        raise ValueError("the decode reads and writes contiguous tensors")


def decode_frames_plain(comp, table, first: int, count: int, out, status,
                        comp_shift: int = 0, out_shift: int = 0) -> None:
    """Decode frames [first, first + count) of ``table`` with
    ``codec.decompress_block``, on CPU tensors: each frame's words into
    its place in ``out``, its raw length into ``status`` (-1 for a frame
    it rejects, whose output is left as it was)."""
    rows = table[first:first + count].tolist()
    for f, (src, n, dst, raw) in enumerate(rows, first):
        payload = comp[src - comp_shift:src - comp_shift + n].numpy().tobytes()
        try:
            block = C.decompress_block(payload, raw, C.CODEC_LZ4)
        except (ValueError, RuntimeError):
            status[f] = -1
            continue
        if raw:
            out[dst - out_shift:dst - out_shift + raw] = torch.frombuffer(
                bytearray(block), dtype=torch.uint8)
        status[f] = raw


def decode_frames(comp: torch.Tensor, table: torch.Tensor, first: int, count: int,
                  out: torch.Tensor, status: torch.Tensor, comp_shift: int = 0,
                  out_shift: int = 0) -> None:
    """Decode frames [first, first + count) of ``table`` (see the module)
    into ``out`` and ``status``: on a CUDA device one launch of the
    kernel on the current stream, one block of one warp a frame
    (``LAUNCHES["lz4_decode"]``; span ``lfs.launch``), none for no
    frames; on the CPU the plain version. Every row decoded must lie
    within ``comp`` and ``out`` after the shifts: the kernel trusts the
    table, and checks only the compressed bytes it decodes."""
    _check(comp, table, first, count, out, status)
    with profiling.span("lfs.launch", mode="lz4_decode", frames=count) if count else \
            profiling.NOOP:
        if comp.device.type == "cpu":
            decode_frames_plain(comp, table, first, count, out, status, comp_shift, out_shift)
            return
        if comp.device.type != "cuda":
            raise ValueError(f"the kernel runs on CUDA tensors, got {comp.device}")
        launch("lfs_lz4_decode", "lz4_decode", comp.device, comp.data_ptr(), comp_shift,
               table.data_ptr(), first, count, out.data_ptr(), out_shift, status.data_ptr(),
               ran=count > 0)

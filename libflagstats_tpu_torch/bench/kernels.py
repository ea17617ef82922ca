"""Per-kernel throughput table against the read roofline.

The port of ``libflagstats_tpu.bench.kernels``, the counterpart of the
reference's per-variant table (linux/instrumented_benchmark.cpp -t):
every device tier of the port, first gated against the cached host
oracle, then timed with the gated multi-K fit (bench/harness.py) on
fresh salted inputs, reported as words/s, GB/s and the fraction of the
defended read roofline (K4 or a torch float32 sum, whichever the
agreement protocol keeps; the footer names it). A row whose sample never
passed the gates ends in '!'; a row whose counters disagree with the
oracle reads MISMATCH and is not timed.

Rows on the card: ``cuda`` in its three modes (K1/K3/K5), ``cuda_pre``
on 32-row plane tiles (K2, flagstat and report), ``cuda_pre_packed`` on
24 rows and ``cuda_pre_packed_report`` on 20 (K2), ``cuda_words`` (K6)
and ``torch``, the word-space tier on the card. With ``device="cpu"``
of these the ``torch`` row only. Each row is priced at the bytes its kernel
reads: 2 per word of raw words, and for plane tiles 4 KiB per row the
mode reads, per group (K2 skips the rows no stream reads, so 32-row
tiles cost what packed ones do). Two set-algebra rows follow
(``setop_popcnt``, one bitmap, 2 bytes per word; ``setop_intersect``,
two bitmaps, 4 bytes per word, against a roofline measured over that
many bytes): K9 on the card, its plain version with
``device="cpu"``, checked against numpy's bit count before timing.

Below ~50 MB of input (L2 on the H100) the salting write leaves the
fresh input in L2, and the rows measure L2, not device memory.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import flags as F
from ..ops import kernels as K
from ..ops.bitslice import pretranspose_host, pretranspose_host_packed
from ..ops.setalgebra import setop_count_cuda
from ..ops.torch_ops import as_words, assemble_counters, stream_sums_torch
from ..ops.words_kernels import stream_sums_words_cuda
from ..oracle import generate_flags
from .harness import defended_roofline, gated_kernel_time_fit, timing_device
from .refcache import oracle_counters, pospopcnt_counters

HEADER = "kernel\twords\ttime_us\tMwords/s\tGB/s\tvs_roofline"
#: repetition counts of the fits: the kernels, and the many-launch torch tier
KS = (4, 64, 260)
KS_TORCH = (1, 2, 4)
SETOP_ROWS = ("setop_popcnt", "setop_intersect")


def _rows(dev: torch.device) -> dict:
    """name -> (input key, body, check kind). A body returns what its
    kernel returns, so the timed call is the wrapper alone; the check
    kind says how its output becomes counters: "full" / "report" (K1 or
    K2 per-stream sums), "pospopcnt", or "streams" ((C, F) concatenated)."""
    rows = {"torch": ("x", lambda a: torch.cat(stream_sums_torch(a)), "streams")}
    if dev.type != "cuda":
        return rows
    return {
        "cuda": ("x", lambda a: K.stream_sums_cuda(a, "flagstat"), "full"),
        "cuda_report": ("x", lambda a: K.stream_sums_cuda(a, "flagstat_report"), "report"),
        "cuda_pospopcnt": ("x", lambda a: K.stream_sums_cuda(a, "pospopcnt"), "pospopcnt"),
        "cuda_pre": ("pre", lambda p: K.stream_sums_pre_cuda(p), "full"),
        "cuda_pre_report": ("pre", lambda p: K.stream_sums_pre_cuda(p, report=True), "report"),
        "cuda_pre_packed": ("packed_full",
                            lambda p: K.stream_sums_pre_cuda(p, packed=True), "full"),
        "cuda_pre_packed_report": ("packed_report",
                                   lambda p: K.stream_sums_pre_cuda(p, True, True), "report"),
        "cuda_words": ("x", lambda a: torch.cat(stream_sums_words_cuda(a)), "streams"),
        **rows,
    }


def _inputs(x_host: np.ndarray, dev: torch.device, keys: set) -> dict:
    args = {"x": as_words(x_host).to(dev)}
    if "pre" in keys:
        args["pre"] = torch.from_numpy(pretranspose_host(x_host)).to(dev)
    for key, report in (("packed_full", False), ("packed_report", True)):
        if key in keys:
            args[key] = torch.from_numpy(
                pretranspose_host_packed(x_host, K.packed_rows_for(report))).to(dev)
    return args


def _counters(out: torch.Tensor, kind: str, n_words: int) -> np.ndarray:
    if kind == "pospopcnt":
        return out.cpu().numpy().astype(np.int64)
    if kind == "streams":
        total, fail = out[:F.N_BITS], out[F.N_BITS:]
    else:
        total, fail = K._sums_to_streams(out, kind == "report")
    return assemble_counters(total, fail, n_words).cpu().numpy()


def counters_ok(out, kind: str, n_words: int, ref: np.ndarray, pp_ref=None) -> bool:
    """Whether a body's output, read as ``kind`` says, equals the oracle:
    all 32 counters, ``flags.REPORT_COUNTERS`` for "report", the 16 of
    ``pp_ref`` for "pospopcnt"."""
    got = _counters(out, kind, n_words)
    if kind == "pospopcnt":
        return bool((got == pp_ref).all())
    idx = list(F.REPORT_COUNTERS) if kind == "report" else list(range(F.N_COUNTERS))
    return bool((got[idx] == ref[idx]).all())


def _row_bytes(name: str, arg: torch.Tensor, n_words: int) -> int:
    """The bytes the row's kernel reads: raw words 2 per word; plane
    tiles 4 KiB per group per row the mode reads."""
    if not name.startswith("cuda_pre"):
        return 2 * n_words
    return arg.shape[0] * len(K.packed_rows_for(name.endswith("_report"))) * 4096


def _timed_row(name: str, n_words: int, fit, nbytes: int, roof) -> str:
    t = fit.slope_s
    frac = f"{nbytes / t / roof:.3f}" if roof else "n/a"
    return (f"{name}\t{n_words}\t{t * 1e6:.1f}\t{n_words / t / 1e6:.0f}\t"
            f"{nbytes / t / 1e9:.1f}\t{frac}{'' if fit.gate_passed else '!'}")


def _host_popcount(u32: np.ndarray) -> int:
    if hasattr(np, "bitwise_count"):             # numpy >= 2
        return int(np.bitwise_count(u32).sum(dtype=np.int64))
    return int(np.unpackbits(u32.view(np.uint8)).sum(dtype=np.int64))


def _setop_rows(x_host: np.ndarray, n_words: int, roof, iters: int,
                dev: torch.device) -> list[str]:
    """The set-algebra rows (reference: STORM_popcnt /
    STORM_intersect_count, libalgebra.h:500-3398): one row over one
    bitmap and one over two characterize the family (union and diff read
    and count what intersect does). The words are the first bitmap, seen
    as 32-bit lanes; the second is seeded."""
    if n_words % 2:                              # 32-bit lanes need even words
        # well-formed 6-column rows so table consumers never break
        return [f"{name}\t{n_words}\tskipped:odd word count\t-\t-\t-" for name in SETOP_ROWS]
    a_host = x_host.view(np.uint32)
    b_host = np.random.default_rng(1).integers(0, 1 << 32, size=a_host.size, dtype=np.uint32)
    a = torch.from_numpy(a_host.view(np.int32)).to(dev)
    b = torch.from_numpy(b_host.view(np.int32)).to(dev)
    # a read of twice the bytes runs at a higher rate (the cost per
    # launch is spread further), so the two-bitmap row gets a roofline
    # measured over its own bytes
    roof2 = defended_roofline(4 * n_words, device=dev) if roof else None
    if roof2 != roof2:
        roof2 = None
    rows = []
    for name, body, nbytes, want, roof in (
        ("setop_popcnt", lambda v: setop_count_cuda(v, None, "popcnt"), 2 * n_words,
         _host_popcount(a_host), roof),
        ("setop_intersect", lambda v: setop_count_cuda(v, b, "intersect"), 4 * n_words,
         _host_popcount(a_host & b_host), roof2),
    ):
        if int(body(a)) != want:
            rows.append(f"{name}\t{n_words}\tMISMATCH")
            continue
        fit = gated_kernel_time_fit(body, a, roof_bytes_per_s=roof, n_bytes=nbytes,
                                    ks=KS if dev.type == "cuda" else KS_TORCH, iters=iters,
                                    device=dev)
        rows.append(_timed_row(name, n_words, fit, nbytes, roof))
    return rows


def run(n_words: int = 64 * 1024 * 1024, iters: int = 5, cache_dir: str | None = None,
        device=None) -> list[str]:
    """The roster's lines: header, one row per tier, the two
    set-algebra rows and, given a roofline, its footer."""
    dev = timing_device(device)
    x_host = generate_flags(n_words, seed=0, full_range=True)
    ref = oracle_counters(x_host, n_words, seed=0, full_range=True, cache_dir=cache_dir)
    pp_ref = pospopcnt_counters(x_host, n_words, seed=0, full_range=True, cache_dir=cache_dir)

    roof, roof_kind = defended_roofline(2 * n_words, with_kind=True, device=dev)
    if roof != roof:  # NaN: no sample passed the gates
        roof = None

    rows = _rows(dev)
    args = _inputs(x_host, dev, {key for key, _, _ in rows.values()})
    lines = [HEADER]
    for name, (key, body, kind) in rows.items():
        arg = args[key]
        if not counters_ok(body(arg), kind, n_words, ref, pp_ref):
            lines.append(f"{name}\t{n_words}\tMISMATCH")
            continue
        nbytes = _row_bytes(name, arg, n_words)
        fit = gated_kernel_time_fit(body, arg, roof_bytes_per_s=roof, n_bytes=nbytes,
                                    ks=KS_TORCH if name == "torch" else KS, iters=iters,
                                    device=dev)
        lines.append(_timed_row(name, n_words, fit, nbytes, roof))
    lines += _setop_rows(x_host, n_words, roof, iters, dev)
    if roof:
        lines.append(f"[roofline:{roof_kind}]\t{n_words}\t-\t-\t{roof / 1e9:.1f}\t1.000")
    return lines

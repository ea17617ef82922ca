"""Measured stage decomposition of the bit-sliced flagstat kernel on the card.

The port of tools/stage_decomposition.py. K1 (ops/csrc/flagstat_kernels.cu)
reads words, transposes them in registers, transforms the planes and
counts them; its time sits on the read, so one stage's cost hides in
the read's shadow. Two regimes, over the same 64Mi full-range words
(BASELINE configs #2/#3; 128 MiB, 2.6x the H100's 50 MB L2):

1. SHADOW CHECK (repeat 1): read (K4), full (K1 flagstat), pre (K2 on
   32-row tiles), and the three K7 probes, transpose, count and
   transform. A stage subset at the read's time is bound by the read.
2. COMPUTE EXTRACTION: each probe runs its stage r times on data it
   chains (ops/csrc/flagstat_probe_kernels.cu), so no rep can be folded
   away. With r1 and r2 both past the read's shadow (T(r1) > EMERGE x
   T(read), found by doubling r from R_START), (T(r2) - T(r1)) /
   (r2 - r1) is the stage's integer time per pass with the read
   cancelled.

Every probe is first gated against the host oracle. Each shadow row is
priced at the bytes its kernel reads (K2 and the transform probe load 24
of the 32 plane rows, the count probe 30).

MODEL_OPS is the port's own 32-bit integer operations per word of one
rep of each chained stage, all classes together, as
ops/probe_kernels.PROBE_OPS counts them in the probes' source (not from
SASS, where LOP3 fuses up to three logic operations): the pruned
transpose 5.25, a transform rep 0.72, a count rep 1.875 plus 0.906
__popc.

Run on the card: python -m libflagstats_tpu_torch.tools.stage_decomposition
It prints a table per regime and, last, one JSON line.
"""
from __future__ import annotations

import json
import sys

import torch

from ..ops import kernels as K
from ..ops import probe_kernels as P

N_WORDS = 64 * 1024 * 1024
#: the probe of each stage
PROBE_OF = {"transpose": "transpose_xor", "count": "raw", "transform": "transform_xor"}
MODEL_OPS = {stage: sum(rep for _, rep in P.PROBE_OPS[key].values())
             for stage, key in PROBE_OF.items()}
#: plane rows of 32 each probe or tier over plane tiles reads
READ_ROWS = {"pre": len(K.packed_rows_for(False)),
             "transform": P.PLANE_ROWS_READ["transform_xor"],
             "count": P.PLANE_ROWS_READ["raw"]}
#: first repeat of the compute extraction's doubling, per stage
R_START = {"transpose": 2, "count": 2, "transform": 16}
R_CAP = 256           # the doubling stops here (r2 = 2 r1)
R_CAP_COUNT = 8       # the count probe's repeat is bounded by its int32
#                       accumulator rule (stream_sums_raw_*): at 64Mi words
#                       at most 31, so r2 = 2 r1 stays <= 16
EMERGE = 1.5          # T(r) must exceed this x the read's time before differencing
KS_FAST = (4, 64, 260)   # repetition counts of the read-speed kernels
KS_SLOW = (4, 16, 48)    # and of the repeat-chained probes
FIT_ITERS = 4
FIT_ATTEMPTS = 4
STAGES = ("transpose", "count", "transform")


def _fit(body, x, ks, dev, roof=None, n_bytes=None):
    from ..bench.harness import gated_kernel_time_fit

    return gated_kernel_time_fit(body, x, roof_bytes_per_s=roof, n_bytes=n_bytes, ks=ks,
                                 iters=FIT_ITERS, attempts=FIT_ATTEMPTS, device=dev)


def _gate(x, planes, x_host, planes_host, n) -> None:
    """Every probe and tier against the host oracle, before any timing."""
    from ..bench.refcache import oracle_counters, pospopcnt_counters
    from ..ops.torch_ops import assemble_counters

    ref = oracle_counters(x_host, n, seed=0, full_range=True)
    pos = pospopcnt_counters(x_host, n, seed=0, full_range=True)
    want = {"read": P.read_xor_np(x_host), "transpose": P.transpose_xor_np(x_host),
            "transform": P.transform_xor_pre_np(planes_host)}
    got = {"read": P.digest(P.read_xor_cuda(x)),
           "transpose": P.digest(P.transpose_xor_cuda(x)),
           "transform": P.digest(P.transform_xor_pre_cuda(planes))}
    assert got == want, f"probe digests {got} != host {want}"
    raw = P.stream_sums_raw_cuda(planes).cpu().numpy()
    expect = P.stream_sums_raw_np(pos)
    assert (raw == expect).all(), f"count probe {raw} != pospopcnt {expect}"
    for name, sums in (("full", K.stream_sums_cuda(x)), ("pre", K.stream_sums_pre_cuda(planes))):
        c = assemble_counters(*K._sums_to_streams(sums, False), n).cpu().numpy()
        assert (c == ref).all(), f"{name} counters {c} != oracle {ref}"


def run(n_words: int = N_WORDS, device=None) -> dict:
    """Gate, then both regimes on ``device`` (default: the current CUDA
    device; raises with no card unless device="cpu"). Prints the tables
    and returns the JSON-able result."""
    from ..bench.harness import defended_roofline, timing_device
    from ..ops.bitslice import pretranspose_host
    from ..ops.torch_ops import as_words
    from ..oracle import generate_flags

    dev = timing_device(device)
    n = n_words
    n_bytes = 2 * n
    x_host = generate_flags(n, seed=0, full_range=True)
    planes_host = pretranspose_host(x_host)
    x = as_words(x_host).to(dev)
    planes = torch.from_numpy(planes_host).to(dev)
    _gate(x, planes, x_host, planes_host, n)
    print("# probes oracle-gated OK", file=sys.stderr)

    def probe_body(stage, r):
        if stage == "transpose":
            return (lambda a: P.transpose_xor_cuda(a, r)), x
        if stage == "count":
            return (lambda p: P.stream_sums_raw_cuda(p, r)), planes
        return (lambda p: P.transform_xor_pre_cuda(p, r)), planes

    def read_bytes(stage):
        return n_bytes * READ_ROWS.get(stage, 32) // 32

    roof, roof_kind = defended_roofline(n_bytes, ks=KS_FAST, with_kind=True, device=dev)
    print(f"# defended roofline {roof / 1e9:.1f} GB/s ({roof_kind})", file=sys.stderr)
    out = {"n_words": n, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else str(dev), "roofline_gbs": roof / 1e9, "roofline_kind": roof_kind,
           "model_ops": MODEL_OPS}

    # -- shadow check: every variant at repeat 1, the same input bytes --
    print("stage\tms\tGB/s\tvs_roof\tdisp\tgate")
    shadow = {}
    rows = [("read", "read", P.read_xor_cuda, x),
            ("full", "full", lambda a: K.stream_sums_cuda(a), x),
            ("pre", "pre", lambda p: K.stream_sums_pre_cuda(p), planes)]
    rows += [(f"{stage}@1", stage, *probe_body(stage, 1)) for stage in STAGES]
    for name, stage, body, inp in rows:
        nb = read_bytes(stage)
        fit = _fit(body, inp, KS_FAST, dev, roof=roof if roof == roof else None, n_bytes=nb)
        gbs = nb / fit.slope_s / 1e9
        shadow[name] = {"ms": fit.slope_s * 1e3, "gbs": gbs, "dispersion": fit.dispersion,
                        "gate_passed": bool(fit.gate_passed)}
        print(f"{name}\t{fit.slope_s * 1e3:.4f}\t{gbs:.1f}\t{gbs * 1e9 / roof:.3f}\t"
              f"{fit.dispersion:.3f}\t{fit.gate_passed}")
    out["shadow"] = shadow

    # -- compute extraction: repeat-chained differencing --
    # double r until T(r) clearly exceeds the read's time (both points
    # must be compute-bound, or the slope measures the read's shadow);
    # refit a pair whose slope comes out negative
    t_read_s = shadow["read"]["ms"] / 1e3
    print("stage\tr1\tr2\tT(r1)ms\tT(r2)ms\talu_ms/pass\timplied_Gops/s\tmodel_ops/word")
    compute = {}
    for stage in STAGES:
        r1 = R_START[stage]
        r_cap = R_CAP_COUNT if stage == "count" else R_CAP
        while True:
            b1, inp = probe_body(stage, r1)
            f1 = _fit(b1, inp, KS_SLOW, dev)
            if f1.slope_s > EMERGE * t_read_s or r1 >= r_cap:
                break
            print(f"# {stage}@{r1} still in the read's shadow ({f1.slope_s * 1e3:.4f} ms "
                  f"vs read {t_read_s * 1e3:.4f}); doubling r", file=sys.stderr)
            r1 *= 2
        r2 = 2 * r1
        b2, inp = probe_body(stage, r2)
        alu_s = None
        for _ in range(3):
            f2 = _fit(b2, inp, KS_SLOW, dev)
            slope = (f2.slope_s - f1.slope_s) / (r2 - r1)
            if slope > 0 and f1.gate_passed and f2.gate_passed:
                alu_s = slope
                break
            print(f"# {stage} pair rejected (slope {slope * 1e3:.5f} ms, gates "
                  f"{f1.gate_passed}/{f2.gate_passed}); refitting", file=sys.stderr)
            f1 = _fit(b1, inp, KS_SLOW, dev)
        ops = MODEL_OPS[stage]
        rate = ops * n / alu_s if alu_s else float("nan")
        compute[stage] = {
            "r": [r1, r2], "t_r1_ms": f1.slope_s * 1e3, "t_r2_ms": f2.slope_s * 1e3,
            "alu_ms": alu_s * 1e3 if alu_s else None, "implied_gops": rate / 1e9,
            "dispersion": max(f1.dispersion, f2.dispersion),
            "gates": [bool(f1.gate_passed), bool(f2.gate_passed)],
            "r1_still_shadowed": bool(f1.slope_s <= EMERGE * t_read_s),
        }
        alu_str = f"{alu_s * 1e3:.4f}" if alu_s else "REJECTED"
        print(f"{stage}\t{r1}\t{r2}\t{f1.slope_s * 1e3:.4f}\t{f2.slope_s * 1e3:.4f}\t"
              f"{alu_str}\t{rate / 1e9:.0f}\t{ops}")
    out["compute"] = compute

    alu_total = sum(c["alu_ms"] or 0.0 for c in compute.values())
    t_read, t_full = shadow["read"]["ms"], shadow["full"]["ms"]
    out["summary"] = {"alu_total_ms": alu_total, "t_read_ms": t_read, "t_full_ms": t_full,
                      "full_overhang_ms": t_full - t_read,
                      "full_predicted_ms": max(t_read, alu_total)}
    print(f"# ALU total {alu_total:.4f} ms vs read {t_read:.4f} ms -> predicted full "
          f"{max(t_read, alu_total):.4f} ms, measured full {t_full:.4f} ms", file=sys.stderr)
    print(json.dumps(out))
    return out


def main() -> int:
    try:
        run()
    except RuntimeError as e:  # no card: one line, no fallback
        print(f"stage_decomposition: error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

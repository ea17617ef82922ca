"""One run of one cell of BENCHMARK.json on the card.

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the configuration's data on the card from the seed, has
the traffic's entry build the form the caller holds it in and the
report call (``generator.prepare``), and warms it with two reports. The
window then sends reports in a closed loop for ``--seconds``, each timed
on the host clock. With ``--trace 1`` the window is a shorter one of at
most ``TRACE_SECONDS`` under ``torch.profiler``, and the per-layer
metrics are read from its trace. After the window every report is
compared, every number of it, with what the entry's plain reference
works out from the benchmark's data. The last line of standard output
is the result's JSON; the numbers compared, beside their limits, are
the last lines of standard error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import generator, spec  # noqa: E402
from .yardstick import REPORT_SPAN, WINDOW_SPAN, TraceView, load_trace  # noqa: E402

WARM_REPORTS = 2
TRACE_SECONDS = 3.0
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "libflagstats_tpu")


@dataclass
class WindowView:
    """What an end-to-end metric reader reads."""

    latencies: list[float]
    completed: int
    words_per_report: int
    seconds: float
    setup_s: float


def forbidden_modules() -> list[str]:
    """Names in ``sys.modules`` whose top-level name (before the first
    dot), compared whole, is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """``name, power.limit`` of each card, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"
    return " | ".join(out.splitlines()) or "unknown"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(report, seconds: float, device: torch.device, span=None):
    """Reports in a closed loop until ``seconds`` have passed since the
    first began: [(result or exception, start, end)]."""
    out = []
    clock = time.perf_counter
    start = clock()
    while True:
        a = clock()
        try:
            if span is None:
                r = report()
            else:
                with span(REPORT_SPAN):
                    r = report()
        except Exception as e:  # a report that raises is a failed report
            r = e
        b = clock()
        out.append((r, a, b))
        if b - start >= seconds:
            break
    _sync(device)
    return out


def traced_window(report, seconds: float, device: torch.device, probe):
    """``window`` under torch.profiler: (reports, trace events)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    probe.reset()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            out = window(report, seconds, device, span=record_function)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = load_trace(path)
    return out, events


def compare(results, expected: np.ndarray) -> tuple[int, int]:
    """(reports failed, widest gap) of every report against the
    reference's integer array: a report fails when it raised, has
    another shape, or differs in any number."""
    failed, gap = 0, 0
    for r, _, _ in results:
        if isinstance(r, Exception):
            failed += 1
            continue
        got = np.asarray(r)
        if got.shape != expected.shape:
            failed += 1
            continue
        g = int(np.max(np.abs(got.astype(np.int64) - expected)))
        gap = max(gap, g)
        failed += g != 0
    return failed, gap


def run(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        scale_divisor: int = 1, control: bool = False, log=sys.stdout) -> dict:
    """One run of the cell ``workload``; returns the result object.
    ``device="cpu"`` and ``scale_divisor`` serve the CPU tests, with the
    program on its plain versions; ``control`` puts the reference's
    control in the program's place (``cardbench.control``). The command
    line has none of them."""
    bench = spec.benchmark()
    cell, config, traffic = spec.cell(bench, workload)
    dev = torch.device(device)
    probe = generator.Probe()
    with contextlib.ExitStack() as stack:
        setup = generator.Setup(config, traffic, probe,
                                None if dev.type == "cuda" else "cpu", stack, log)
        prep = generator.prepare(setup, seed, dev, scale_divisor)
        report = prep.report
        if control:
            report = lambda: prep.reference.control(prep.held, dev)  # noqa: E731
        for _ in range(WARM_REPORTS):
            report()
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - T0
        if trace:
            results, events = traced_window(report, min(seconds, TRACE_SECONDS), dev, probe)
        else:
            results, events = window(report, seconds, dev), None
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del report
        prep.report = None
        gc.collect()
        expected = prep.reference.exact(prep.held, dev)
    failed, gap = compare(results, expected)
    completed = sum(not isinstance(r, Exception) for r, _, _ in results)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(results) and failed == 0 and gap == 0,
           "attempted": len(results), "failed": failed}
    print(f"workload {workload} seed {seed} config {cell['config']} "
          f"traffic {cell['traffic']}", file=log)
    print(f"card {card_line() if dev.type == 'cuda' else 'none'}; "
          f"devices {torch.cuda.device_count() if dev.type == 'cuda' else 0}", file=log)
    print(f"reports {len(results)} of {prep.words} words; completed {completed}; "
          f"window {results[-1][2] - results[0][1]:.4f} s; setup {setup_s:.4f} s", file=log)
    if trace:
        view = TraceView(events, reports=completed, words=completed * prep.words,
                         kind=kind, sections=dict(probe.timer.totals),
                         spans={k: list(v) for k, v in probe.spans.items()})
        metrics = {}
        for m in spec.metrics(bench, "per_layer", workload):
            value = spec.module("layer_metrics", m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=view.busy_s(), window_s=view.window_s)
        out.update(metrics=metrics, device=device_info, breakdown=view.breakdown())
    else:
        wv = WindowView(latencies=[b - a for _, a, b in results], completed=completed,
                        words_per_report=prep.words,
                        seconds=results[-1][2] - results[0][1], setup_s=setup_s)
        out.update(metrics={m["name"]: {"value": spec.module("end_to_end", m["name"]).read(wv),
                                        "unit": m["unit"]}
                            for m in spec.metrics(bench, "end_to_end", workload)},
                   device=device_info)
    out["checks"] = {"reports_failed": {"value": failed, "limit": 0},
                     "counter_gap_max": {"value": gap, "limit": 0}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cardbench.run", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = spec.cell(spec.benchmark(), args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"cardbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Profiling utilities: a device trace and a wall-clock section timer.

The port of ``libflagstats_tpu.bench.profiling``: ``trace`` records with
torch.profiler where the JAX package uses jax.profiler, and
``SectionTimer`` times host pipeline stages."""
from __future__ import annotations

import contextlib
import time
from pathlib import Path


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a trace of the CPU and, with a card, of the CUDA device
    around a block:

        with profiling.trace("trace_dir"):
            fn(x)
            torch.cuda.synchronize()

    Device work must have finished before the block ends. A Chrome trace
    file ``<time>.trace.json`` is written into ``logdir`` (made if
    missing) when the block ends; open it with ui.perfetto.dev. Yields
    ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield str(logdir)
    finally:
        prof.stop()
        prof.export_chrome_trace(str(Path(logdir) / f"{time.time_ns()}.trace.json"))


class SectionTimer:
    """Accumulating named wall-clock sections (host-side pipeline stages)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Accumulate one section timed elsewhere (e.g. on a worker
        thread, whose time the owner adds when it takes the result)."""
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total*1e3:.2f} ms total, {n} calls, "
                         f"{total/n*1e6:.1f} us/call")
        return "\n".join(lines)

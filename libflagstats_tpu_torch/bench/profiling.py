"""Wall-clock section timer for host pipeline stages.

The port's counterpart of ``SectionTimer`` in
``libflagstats_tpu.bench.profiling``; the device trace helper there
(``trace``, on jax.profiler) waits for a torch.profiler version."""
from __future__ import annotations

import contextlib
import time


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
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total*1e3:.2f} ms total, {n} calls, "
                         f"{total/n*1e6:.1f} us/call")
        return "\n".join(lines)

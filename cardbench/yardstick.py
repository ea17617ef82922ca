"""The benchmark's arithmetic: percentiles, the union of device
intervals, idle gaps, a roofline share, and the reading of a
``torch.profiler`` Chrome trace. Pure Python; times in the trace are
microseconds."""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
NAME_CHARS = 200
WINDOW_SPAN = "cardbench.window"
REPORT_SPAN = "cardbench.report"
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def percentile(values, q: float) -> float:
    """The q-quantile (0 <= q <= 1) by linear interpolation between
    closest ranks (numpy's default method)."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    h = (len(s) - 1) * q
    lo = math.floor(h)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (h - lo) * (s[hi] - s[lo])


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def union_length(intervals, lo: float, hi: float) -> float:
    return sum(b - a for a, b in merge(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def roofline_share(bytes_moved: float, seconds: float, bytes_per_s: float) -> float:
    """Percent of the least time (bytes at the peak rate) in ``seconds``."""
    return 100.0 * (bytes_moved / bytes_per_s) / seconds


def load_trace(path) -> list[dict]:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def span(e) -> tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


@dataclass
class TraceView:
    """What a per-layer metric reader reads: the traced window's events,
    and the benchmark's own counts, sections and spans over the reports
    in it."""

    events: list[dict]
    reports: int
    words: int
    kind: str = ""
    sections: dict[str, float] = field(default_factory=dict)
    spans: dict[str, list[float]] = field(default_factory=dict)

    def __post_init__(self):
        win = [e for e in self.events if e.get("name") == WINDOW_SPAN]
        if win:
            self.lo, self.hi = span(win[0])
        else:
            self.lo = self.hi = 0.0

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def device(self, cats=DEVICE_CATS) -> list[dict]:
        """Device events of ``cats`` that overlap the window."""
        if not hasattr(self, "_device"):
            self._device = [e for e in self.events if e.get("cat") in DEVICE_CATS
                            and span(e)[1] > self.lo and span(e)[0] < self.hi]
        return [e for e in self._device if e["cat"] in cats]

    def busy_s(self) -> float:
        return union_length([span(e) for e in self.device()], self.lo, self.hi) * 1e-6

    def peak(self, key: str):
        """The published peak ``key`` of this card, or None."""
        return PEAKS.get(self.kind, {}).get(key)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each named by the innermost host operation under way
        at its middle (names cut to ``NAME_CHARS``)."""
        by_name: dict[str, float] = {}
        device = self.device()
        for e in device:
            a, b = clip([span(e)], self.lo, self.hi)[0]
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(gaps([span(e) for e in device], self.lo, self.hi),
                         key=lambda g: g[0] - g[1])[:top]
        host = [e for e in self.events if e.get("cat") in HOST_CATS]
        idle = []
        for a, b in longest:
            mid = (a + b) / 2
            under = [e for e in host if span(e)[0] <= mid <= span(e)[1]]
            name = max(under, key=lambda e: e["ts"])["name"] if under else "no host op"
            idle.append((name, (b - a) * 1e-6))
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle]}

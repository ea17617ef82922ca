"""Hardware perf-counter accounting for the native host tier.

The port of ``libflagstats_tpu.bench.perf_native``. It counts cycles,
instructions, branch misses and cache references and misses per 16-bit
word around the native host kernels (``lfs_flagstat_u16``,
``lfs_pospopcnt_u16``) with perf_event_open counter groups, the set the
reference reports with overhead self-calibration (reference:
linux/linux-perf-events.h:16-90, linux/instrumented_benchmark.cpp:
161-166, 263-268, 417-454). It counts the host; the card's kernels are
timed by the harness.

The counter groups live in ``io/csrc/perf_events.cpp`` (a byte-for-byte
copy of the JAX package's), built at first use into a small shared
object of its own (``io/native_lib.load_perf()``): it includes
``<linux/perf_event.h>``, and a host that lacks the header must not
lose the host library that the codecs and the stream need. A failed
build is kept in ``native_lib.PERF_BUILD_ERROR``; ``available()`` is
then False and the report names the error.

Degradation contract: virtualized hosts often expose no hardware PMU
(perf_event_open -> ENOENT for PERF_TYPE_HARDWARE), and containers may
block the syscall altogether. The shim reports per-event availability
(ok_mask), and ``measure`` labels its output with which events are
real; with no hardware event it still counts software events
(task-clock, page faults), so the plumbing is exercised and the caller
can say "no PMU" instead of printing inferred numbers as counted ones.
With no event at all the report says so and why, and nothing fails.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

from ..io import native_lib

# perf_event_attr type/config constants (linux/perf_event.h ABI)
PERF_TYPE_HARDWARE = 0
PERF_TYPE_SOFTWARE = 1
HW_CPU_CYCLES = 0
HW_INSTRUCTIONS = 1
HW_CACHE_REFERENCES = 2
HW_CACHE_MISSES = 3
HW_BRANCH_MISSES = 5
HW_REF_CPU_CYCLES = 9
SW_TASK_CLOCK = 1          # nanoseconds of on-CPU time
SW_PAGE_FAULTS = 2

#: the reference's counter set (instrumented_benchmark.cpp:161-166)
HARDWARE_EVENTS = [
    ("cycles", PERF_TYPE_HARDWARE, HW_CPU_CYCLES),
    ("instructions", PERF_TYPE_HARDWARE, HW_INSTRUCTIONS),
    ("branch_misses", PERF_TYPE_HARDWARE, HW_BRANCH_MISSES),
    ("cache_refs", PERF_TYPE_HARDWARE, HW_CACHE_REFERENCES),
    ("cache_misses", PERF_TYPE_HARDWARE, HW_CACHE_MISSES),
    ("ref_cycles", PERF_TYPE_HARDWARE, HW_REF_CPU_CYCLES),
]
SOFTWARE_EVENTS = [
    ("task_clock_ns", PERF_TYPE_SOFTWARE, SW_TASK_CLOCK),
    ("page_faults", PERF_TYPE_SOFTWARE, SW_PAGE_FAULTS),
]


def _lib():
    return native_lib.load_perf()


def unavailable_reason() -> str:
    """Why no counter group opens here: the perf object's build error,
    or that perf_event_open opened no event ("" when one opens)."""
    if _lib() is None:
        lines = native_lib.PERF_BUILD_ERROR.splitlines() or [""]
        # the compiler's own error line says more than the wrapper's first line
        first = next((ln.strip() for ln in lines if "error" in ln and "g++ failed" not in ln),
                     lines[0])
        return f"the perf object did not build ({first})"
    if not available():
        return "perf_event_open opened no event (blocked on this host)"
    return ""


class PerfGroup:
    """A perf_event counter group around a code region.

    ``names`` lists the events that actually opened (virtualized hosts
    drop the hardware ones); start()/stop() bracket the measured region
    and stop() returns {name: count}.
    """

    def __init__(self, events=None):
        self.handle = -1
        self.names: list[str] = []
        lib = _lib()
        if lib is None:
            return
        events = list(HARDWARE_EVENTS + SOFTWARE_EVENTS
                      if events is None else events)
        types = (ctypes.c_uint32 * len(events))(*[e[1] for e in events])
        cfgs = (ctypes.c_uint64 * len(events))(*[e[2] for e in events])
        mask = ctypes.c_uint64(0)
        h = lib.lfs_perf_open(types, cfgs, len(events), ctypes.byref(mask))
        if h < 0:
            return
        self.handle = h
        self.names = [e[0] for i, e in enumerate(events)
                      if mask.value & (1 << i)]
        self._lib = lib
        self._buf = (ctypes.c_uint64 * len(self.names))()

    @property
    def ok(self) -> bool:
        return self.handle >= 0

    @property
    def has_hardware(self) -> bool:
        return "cycles" in self.names

    def start(self) -> None:
        self._lib.lfs_perf_start(self.handle)

    def stop(self) -> dict[str, int]:
        n = self._lib.lfs_perf_stop(self.handle, self._buf)
        if n != len(self.names):
            raise RuntimeError(f"perf group read failed (rc={n})")
        return dict(zip(self.names, list(self._buf)))

    def close(self) -> None:
        if self.handle >= 0:
            self._lib.lfs_perf_close(self.handle)
            self.handle = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def available() -> bool:
    g = PerfGroup()
    try:
        return g.ok
    finally:
        g.close()


def hardware_available() -> bool:
    g = PerfGroup()
    try:
        return g.ok and g.has_hardware
    finally:
        g.close()


@dataclass
class CountedRun:
    """Per-word counted metrics for one kernel (min over iterations,
    overhead-calibrated — the reference's discipline)."""

    name: str
    n_words: int
    iters: int
    counted: bool                    # True iff hardware events were real
    events: list = field(default_factory=list)
    min_per_word: dict = field(default_factory=dict)
    avg_per_word: dict = field(default_factory=dict)
    overhead: dict = field(default_factory=dict)

    @property
    def ipc(self) -> float | None:
        c = self.min_per_word.get("cycles")
        i = self.min_per_word.get("instructions")
        # a PMU can expose a SUBSET of hardware events (each opens
        # independently); IPC needs both
        return (i / c) if (c and i is not None) else None


def measure(fn, n_words: int, iters: int = 9, make_input=None,
            events=None) -> CountedRun | None:
    """Count the perf events around ``fn(arr)`` on fresh random data per
    iteration (the reference draws fresh data per iteration so the
    kernel cannot win from a warmed branch predictor / cache,
    instrumented_benchmark.cpp:174-179); reports min and avg per word
    minus the measured start/stop overhead (":417-454").

    ``make_input``: optional (iteration) -> uint16 array factory
    replacing the default fresh-random generator (e.g. to count a real
    dataset)."""
    from ..oracle import generate_flags

    if make_input is None:
        def make_input(i):
            return generate_flags(n_words, seed=1000 + i, full_range=True)

    g = PerfGroup(events)
    if not g.ok:
        return None
    try:
        # overhead self-calibration: min of empty start/stop pairs
        overhead: dict[str, int] = {}
        for _ in range(max(iters, 10)):
            g.start()
            res = g.stop()
            for k, v in res.items():
                overhead[k] = min(overhead.get(k, 1 << 62), v)

        mins: dict[str, float] = {}
        sums: dict[str, float] = {}
        for i in range(iters):
            arr = make_input(i)
            g.start()
            fn(arr)
            res = g.stop()
            for k, v in res.items():
                net = max(v - overhead.get(k, 0), 0)
                mins[k] = min(mins.get(k, float("inf")), net)
                sums[k] = sums.get(k, 0.0) + net
        return CountedRun(
            name=getattr(fn, "__name__", "kernel"),
            n_words=n_words,
            iters=iters,
            counted=g.has_hardware,
            events=list(g.names),
            min_per_word={k: v / n_words for k, v in mins.items()},
            avg_per_word={k: v / (n_words * iters) for k, v in sums.items()},
            overhead=dict(overhead),
        )
    finally:
        g.close()


def native_kernel_report(n_words: int = 1 << 24, iters: int = 9) -> list:
    """CountedRun rows for the native host kernels (single-thread, the
    per-core number the reference reports)."""
    from ..ops import native_host

    if not native_host.available():
        return []
    rows = []
    for name, fn in (
        ("lfs_flagstat_u16",
         lambda a: native_host.flagstat_native(a, threads=1)),
        ("lfs_pospopcnt_u16",
         lambda a: native_host.pospopcnt_native(a, threads=1)),
    ):
        run = measure(fn, n_words, iters=iters)
        if run is not None:
            run.name = name
            rows.append(run)
    return rows


def format_report(rows: list) -> str:
    """TSV table in the reference's instrumented style (one row per
    kernel; per-word min/avg for each counted event + IPC)."""
    if not rows:
        return f"perf_event unavailable: {unavailable_reason() or 'no event opened'}"
    cols = rows[0].events
    out = ["\t".join(["kernel", "words", "counted"]
                     + [f"min_{c}/word" for c in cols] + ["IPC"])]
    for r in rows:
        ipc = r.ipc
        out.append("\t".join(
            [r.name, str(r.n_words), "hw" if r.counted else "sw-only"]
            + [f"{r.min_per_word.get(c, float('nan')):.6g}" for c in cols]
            + [f"{ipc:.3f}" if ipc else "n/a"]))
    if not rows[0].counted:
        out.append("# no hardware PMU exposed on this host "
                   "(perf_event_open ENOENT for PERF_TYPE_HARDWARE): "
                   "hardware columns are absent, software events only — "
                   "cycles/word here remains wall-clock-inferred")
    return "\n".join(out)

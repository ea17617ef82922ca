"""Profiling utilities: a device trace, spans inside the program, and a
wall-clock section timer.

The port of ``libflagstats_tpu.bench.profiling``: ``trace`` records with
torch.profiler where the JAX package uses jax.profiler, and
``SectionTimer`` times host pipeline stages.

``span`` marks where a layer of the port works (dispatch, kernel launch,
staging, the stream's decode; the ``lfs.*`` names of PERF.md). A span
records only while a torch.profiler session records the calling thread:
otherwise a span site costs one flag check and returns the shared no-op
``NOOP`` (or, given a ``timer``, adds its section to it and nothing
else). A recorded span keeps its name, its ``perf_counter_ns`` start and
end, its thread, its parent, the identifier of the entry call it belongs
to and its ``args`` (words, bytes, pieces, mode, frames) in a bounded
buffer that ``spans()`` reads. On the calling thread it also opens a
record function of its name, so it lies in the same Chrome trace as the
kernels and copies, on the trace's clock. Spans of the worker threads of
an entry call (the stream's decode runs, its transposes) take the
decision and the parent that the call took on its own thread
(``current()``, passed as ``under``); torch.profiler records nothing of
such a thread, so ``to_trace_us`` maps them onto the trace's clock and
``trace`` writes them into its file on their own rows."""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import threading
import time
from collections import deque
from pathlib import Path

import torch
from torch.autograd import _profiler_enabled

#: the prefix of every span name of the port
PREFIX = "lfs."
#: spans kept in memory; past it the oldest go, counted by ``dropped()``
SPAN_CAP = 1 << 18

_RecordFunction = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.autograd.profiler.record_function
_SPANS: deque = deque(maxlen=SPAN_CAP)
_DROPPED = [0]
_IDS = itertools.count(1)
_LOCAL = threading.local()
_HERE = object()


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a trace of the CPU and, with a card, of the CUDA device
    around a block:

        with profiling.trace("trace_dir"):
            fn(x)
            torch.cuda.synchronize()

    Device work must have finished before the block ends. A Chrome trace
    file ``<time>.trace.json`` is written into ``logdir`` (made if
    missing) when the block ends; open it with ui.perfetto.dev. The
    port's spans of the calling thread are in it as the profiler records
    them; those of worker threads (the stream's decode runs and
    transposes) are added on rows of their own, ``lfs worker <tid>``.
    Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    first = next(_IDS)
    prof.start()
    try:
        yield str(logdir)
    finally:
        prof.stop()
        path = Path(logdir) / f"{time.time_ns()}.trace.json"
        prof.export_chrome_trace(str(path))
        _add_worker_spans(path, [s for s in spans() if s.id > first])


def _add_worker_spans(path: Path, recorded: list) -> None:
    """Write the spans of ``recorded`` that the profiler did not see into
    the Chrome trace at ``path``, as complete events on its clock."""
    if all(s.traced for s in recorded):
        return
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    pid = os.getpid()
    added, rows = [], {}
    for e in to_trace_us(recorded, events):
        if e.pop("traced"):
            continue
        rows[e["tid"]] = f"lfs worker {e.pop('thread_name') or e['tid']}"
        added.append({"ph": "X", "cat": "lfs_span", "pid": pid, **e})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in rows.items()] + added
    with open(path, "w") as f:
        json.dump(data, f)


def _here() -> tuple[list, int]:
    """The calling thread's open spans and its native id (a system call
    each time it is asked, so asked once)."""
    here = getattr(_LOCAL, "here", None)
    if here is None:
        here = _LOCAL.here = ([], threading.get_native_id())
    return here


class _Noop:
    """The span of a site that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **args) -> None:
        pass


NOOP = _Noop()


class _Timed(_Noop):
    """A site's section of a timer, recorded nowhere else."""

    __slots__ = ("timer", "section", "start_ns")

    def __init__(self, timer, section: str):
        self.timer, self.section = timer, section

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.timer.add(self.section, (time.perf_counter_ns() - self.start_ns) * 1e-9)
        return False


class Span:
    """One recorded span: ``name``; ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``; ``thread`` (native id) and, on a worker,
    ``thread_name``; ``id``, ``parent`` (the enclosing span's id, or
    None) and ``call`` (the id of the entry call's span, shared by all
    its spans); ``args``; ``traced``: whether it opened a record function
    on a thread that torch.profiler records."""

    __slots__ = ("name", "args", "id", "parent", "call", "thread", "thread_name", "traced",
                 "start_ns", "end_ns", "_timer", "_section", "_rf", "_stack")

    def __init__(self, name: str, args: dict, timer, section, parent, traced: bool):
        self.name, self.args, self.traced = name, args, traced
        self._timer, self._section, self._rf = timer, section, None
        self.id = next(_IDS)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else self.id
        self._stack, self.thread = _here()
        self.thread_name = None if traced else threading.current_thread().name

    def __enter__(self):
        self._stack.append(self)
        if self.traced:
            self._rf = _RecordFunction(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self._stack.pop()
        if self._timer is not None:
            self._timer.add(self._section, (self.end_ns - self.start_ns) * 1e-9)
            self._timer = None
        if len(_SPANS) == SPAN_CAP:
            _DROPPED[0] += 1
        _SPANS.append(self)
        return False

    def note(self, **args) -> None:
        """Add ``args`` known only once the span is open."""
        self.args.update(args)


def span(name: str, timer=None, section: str | None = None, under=_HERE, **args):
    """The span ``name`` of one site, as a context manager; ``note(**args)``
    on what it yields adds args known later.

    It records while torch.profiler records the calling thread, under
    the innermost span open there. A worker thread passes ``under``: the
    ``current()`` of the entry call's thread, taken when it handed the
    work over (None: the call records nothing). ``timer`` (anything with
    ``add(name, seconds)``, such as a SectionTimer) gets the span's time
    as the section ``section`` (default: the name's last dotted part),
    whether or not the span records."""
    if under is _HERE:
        if _profiler_enabled():
            stack = _here()[0]
            return Span(name, args, timer, section or name.rpartition(".")[2],
                        stack[-1] if stack else None, True)
    elif under is not None:
        return Span(name, args, timer, section or name.rpartition(".")[2], under, False)
    if timer is None:
        return NOOP
    return _Timed(timer, section or name.rpartition(".")[2])


def current():
    """The innermost span recording on this thread, or None: what a
    worker of the call passes to ``span`` as ``under``."""
    here = getattr(_LOCAL, "here", None)
    return here[0][-1] if here and here[0] else None


def spans() -> list[Span]:
    """The recorded spans, oldest first."""
    return list(_SPANS)


def dropped() -> int:
    """Spans recorded past SPAN_CAP since the last ``clear_spans()``: the
    oldest, no longer in ``spans()``."""
    return _DROPPED[0]


def clear_spans() -> None:
    _SPANS.clear()
    _DROPPED[0] = 0


def to_trace_us(recorded, events) -> list[dict]:
    """``recorded`` spans on the clock of a Chrome trace's ``events``,
    as complete-event fields: ``name``, ``ts`` and ``dur`` (us), ``tid``,
    ``args`` (with ``id``, ``parent`` and ``call``), ``traced`` and
    ``thread_name``. The offset from ``perf_counter_ns`` to the trace's
    ``ts`` is the median over the traced spans paired with the trace's
    events of their names, in order from the last of each name (earlier
    spans of the buffer belong to earlier sessions). [] when no span
    pairs with an event."""
    seen: dict[str, list[float]] = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith(PREFIX):
            seen.setdefault(name, []).append(float(e["ts"]))
    starts: dict[str, list[int]] = {}
    for s in recorded:
        if s.traced:
            starts.setdefault(s.name, []).append(s.start_ns)
    offsets = []
    for name, mine in starts.items():
        theirs = sorted(seen.get(name, ()))
        k = min(len(mine), len(theirs))
        if k:
            offsets += [t - s / 1e3 for t, s in zip(theirs[-k:], sorted(mine)[-k:])]
    if not offsets:
        return []
    off = statistics.median(offsets)
    return [{"name": s.name, "ts": s.start_ns / 1e3 + off, "dur": (s.end_ns - s.start_ns) / 1e3,
             "tid": s.thread, "args": {**s.args, "id": s.id, "parent": s.parent,
                                       "call": s.call},
             "traced": s.traced, "thread_name": s.thread_name} for s in recorded]


class SectionTimer:
    """Accumulating named wall-clock sections (host-side pipeline stages).
    The stream's sites feed it through ``span(..., timer=...)``."""

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

"""The port's spans (bench/profiling.py ``span``) on the CPU, under
torch.profiler with CPU activity: the staged path's pieces and launches,
a column counted where it lies, the stream's decode runs on its workers
and its waits on the calling thread, nothing at all with the profiler
off, the mapping onto the trace's clock, and the exporter's worker rows."""
import glob
import json
import math
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.bench import profiling as P
from libflagstats_tpu_torch.io import codec as C
from libflagstats_tpu_torch.ops import staging as ST
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags

PIECE = 4096
GW = 65536          # the stream's run: one transpose group, whole frames of it
STREAM_IMPLS = ("torch", "cuda", "cuda_pre")


@pytest.fixture(autouse=True)
def empty_buffer():
    P.clear_spans()
    yield
    P.clear_spans()


def traced(fn):
    """(fn's result, the spans it recorded under torch.profiler)."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, P.spans()


def chrome_events(prof_dir):
    (path,) = glob.glob(str(prof_dir / "*.trace.json"))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def named(spans, name):
    return [s for s in spans if s.name == name]


def check_tree(spans):
    """One entry call: every span carries its id, and each parent
    encloses its child."""
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    for s in spans:
        assert s.call == root.id
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


@pytest.mark.parametrize("n", [0, 1, PIECE, 3 * PIECE + 5])
def test_staged_call_records_a_copy_and_a_launch_a_piece(monkeypatch, n):
    monkeypatch.setattr(ST, "STAGE_WORDS", PIECE)
    x = generate_flags(n, seed=11 + n, full_range=True)
    got, spans = traced(lambda: L.flagstats_u16(x, impl="cuda", device="cpu"))
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    pieces = math.ceil(n / PIECE)
    copies = named(spans, "lfs.stage.copy_in")
    assert len(copies) == pieces == len(named(spans, "lfs.launch"))
    assert sum(s.args["bytes"] for s in copies) == 2 * n
    assert len(named(spans, "lfs.stage.acquire")) == len(named(spans, "lfs.stage.ship")) == pieces
    (call,) = named(spans, "lfs.flagstats_u16")
    assert call.args == {"words": n, "impl": "cuda", "held": "host"}
    assert all(s.traced for s in spans)
    check_tree(spans)


def test_a_column_counted_where_it_lies_stages_nothing():
    x = torch.from_numpy(generate_flags(3 * PIECE + 5, seed=3, full_range=True).view(np.int16))
    got, spans = traced(lambda: L.flagstats_u16(x, impl="torch", device="cpu"))
    np.testing.assert_array_equal(got, flagstat_numpy(x.numpy().view(np.uint16)))
    assert not [s for s in spans if s.name.startswith("lfs.stage.")]
    assert {s.name for s in spans} == {"lfs.flagstats_u16", "lfs.assemble", "lfs.readback"}
    check_tree(spans)


@pytest.fixture
def framed(tmp_path):
    x = generate_flags(200_001, seed=5, full_range=True)
    path = tmp_path / "x.lz4"
    C.write_framed(path, x, codec="lz4", level=1, block_bytes=20_000)
    return path, x


@pytest.mark.parametrize("impl", STREAM_IMPLS)
def test_stream_decode_runs_on_workers_waits_on_the_caller(framed, impl):
    path, x = framed
    timer = P.SectionTimer()
    got, spans = traced(lambda: L.flagstat_stream(path, "lz4", impl=impl, chunk_words=GW,
                                                  timer=timer, device="cpu"))
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    main = threading.get_native_id()
    decodes = named(spans, "lfs.stream.decode")
    runs = timer.counts["decode"]
    assert len(decodes) == runs == 4           # 200,001 words in runs of 60,000
    assert all(s.thread != main and not s.traced for s in decodes)
    assert sum(s.args["words"] for s in decodes) == len(x)
    waits = named(spans, "lfs.stream.decode_wait")
    assert len(waits) == timer.counts["decode_wait"] == runs
    assert all(s.thread == main and s.traced for s in waits)
    assert len(named(spans, "lfs.stream.dispatch")) == timer.counts["dispatch"] == runs
    assert (len(named(spans, "lfs.stream.transpose_wait"))
            == timer.counts.get("transpose_wait", 0) == (runs if impl == "cuda_pre" else 0))
    assert len(named(spans, "lfs.launch")) == (0 if impl == "torch" else runs)
    (call,) = named(spans, "lfs.flagstat_stream")
    assert call.args == {"impl": impl, "frames": 21}
    check_tree(spans)


def test_card_stream_copies_on_workers_and_launches_the_decode(framed, monkeypatch):
    """Where the card decodes (here its plain version): a worker's
    ``lfs.stream.decode`` is the copy of a part of a run's bytes of the
    file (two parts a run, with 8 decode threads for 4 runs at once), the
    calling thread waits in ``lfs.stream.decode_wait`` once a run, and each
    ``lfs.stream.dispatch`` holds one decode launch and one count, each
    an ``lfs.launch``; the statuses come back in ``lfs.readback``."""
    from libflagstats_tpu_torch.io import stream as S

    monkeypatch.setattr(S, "_card_decodes", lambda codec, impl, dev: impl == "cuda")
    path, x = framed
    timer = P.SectionTimer()
    got, spans = traced(lambda: L.flagstat_stream(path, "lz4", impl="cuda", chunk_words=GW,
                                                  timer=timer, device="cpu"))
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    main = threading.get_native_id()
    copies = named(spans, "lfs.stream.decode")
    assert len(copies) == timer.counts["decode"] == 2 * len(named(spans,
                                                                   "lfs.stream.decode_wait"))
    assert all(s.thread != main and not s.traced for s in copies)
    assert sum(s.args["bytes"] for s in copies) == path.stat().st_size
    assert sum(s.args["frames"] for s in copies) == 2 * 21
    dispatches = named(spans, "lfs.stream.dispatch")
    launches = named(spans, "lfs.launch")
    assert len(dispatches) == timer.counts["dispatch"] and len(launches) == 2 * len(dispatches)
    assert sum(s.args["frames"] for s in launches if s.args["mode"] == "lz4_decode") == 21
    assert len(named(spans, "lfs.readback")) == 2     # the statuses, then the counters
    check_tree(spans)


def test_with_the_profiler_off_nothing_is_recorded(framed, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert P.span("lfs.launch", mode="flagstat", words=1) is P.NOOP
    assert P.current() is None
    monkeypatch.setattr(ST, "STAGE_WORDS", PIECE)
    x = generate_flags(2 * PIECE, seed=2, full_range=True)
    L.flagstats_u16(x, impl="cuda", device="cpu")
    timer = P.SectionTimer()
    L.flagstat_stream(framed[0], "lz4", impl="cuda", chunk_words=GW, timer=timer,
                      device="cpu")
    assert P.spans() == [] and P.dropped() == 0
    assert timer.counts["decode"] == timer.counts["decode_wait"] == 4   # the timer still adds


def test_spans_map_onto_the_trace_clock(framed, tmp_path):
    path, x = framed
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        L.flagstat_stream(path, "lz4", impl="cuda_pre", chunk_words=GW, device="cpu")
    prof.export_chrome_trace(str(tmp_path / "t.trace.json"))
    events = chrome_events(tmp_path)
    mapped = P.to_trace_us(P.spans(), events)
    assert len(mapped) == len(P.spans())
    seen = {}
    for e in events:
        if e["name"].startswith(P.PREFIX):
            seen.setdefault(e["name"], []).append(float(e["ts"]))
    for m in mapped:
        if m["traced"]:
            assert min(abs(m["ts"] - t) for t in seen[m["name"]]) < 50.0, m
    (stream,) = [e for e in events if e["name"] == "lfs.flagstat_stream"]
    lo, hi = float(stream["ts"]), float(stream["ts"]) + float(stream["dur"])
    decodes = [m for m in mapped if m["name"] == "lfs.stream.decode"]
    assert len(decodes) == 4
    assert all(lo <= m["ts"] and m["ts"] + m["dur"] <= hi for m in decodes)


def test_trace_writes_the_worker_spans_into_its_file(framed, tmp_path):
    path, x = framed
    with P.trace(tmp_path / "tr"):
        L.flagstat_stream(path, "lz4", impl="cuda_pre", chunk_words=GW, device="cpu")
    events = chrome_events(tmp_path / "tr")
    workers = [e for e in events if e.get("cat") == "lfs_span"]
    assert sorted(e["name"] for e in workers) == ["lfs.stage.transpose"] * 4 + [
        "lfs.stream.decode"] * 4
    (stream,) = [e for e in events if e["name"] == "lfs.flagstat_stream"]
    assert all(e["args"]["call"] == e["args"]["parent"] for e in workers)
    assert {e["tid"] for e in workers}.isdisjoint({stream["tid"]})
    with open(glob.glob(str(tmp_path / "tr" / "*.trace.json"))[0]) as f:
        rows = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "M"
                and e["args"].get("name", "").startswith("lfs worker")]
    assert {e["tid"] for e in rows} == {e["tid"] for e in workers}

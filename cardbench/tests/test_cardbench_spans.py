"""The readers of the program's spans (``lfs.*``): on hand-made events,
without them, and in traced CPU rehearsals of each cell."""
import io
from types import SimpleNamespace

import pytest

from cardbench import run, spec
from cardbench.yardstick import TraceView

NEW = ("dispatch_self_us_p50", "launch_us_p50", "host_copy_gbps", "ring_wait_share",
       "decode_wait_share")
SEED = 2**31 + 77
DIVISOR = 256


def ev(name, ts, dur, tid=1, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": {}}


# a 1000 us window: two block calls, one stream call; the second call's
# copy lies on another thread, and a launch lies outside the window
EVENTS = [
    ev("cardbench.window", 0.0, 1000.0, cat="user_annotation"),
    ev("lfs.flagstats_u16", 10.0, 100.0),
    ev("lfs.stage.copy_in", 20.0, 30.0),
    ev("lfs.launch", 40.0, 20.0),           # overlaps the copy: union 20-60
    ev("lfs.readback", 90.0, 10.0),
    ev("lfs.flagstats_u16", 200.0, 50.0),
    ev("lfs.stage.copy_in", 210.0, 10.0, tid=2),
    ev("lfs.launch", 220.0, 4.0),
    ev("lfs.flagstat_stream", 300.0, 600.0),
    ev("lfs.stream.decode_wait", 320.0, 150.0),
    ev("lfs.stream.decode_wait", 500.0, 150.0),
    ev("lfs.stage.acquire", 700.0, 60.0),
    ev("lfs.launch", 780.0, 6.0),
    ev("lfs.launch", 1500.0, 9.0),
]


def view(events=EVENTS):
    return TraceView(events, reports=2, words=1000, kind="cpu")


def read(name, v):
    return spec.module("layer_metrics", name).read(v)


def recorded(name, start_ns, end_ns, traced=True, **args):
    return SimpleNamespace(name=name, start_ns=start_ns, end_ns=end_ns, traced=traced,
                           args=args, thread=1, thread_name=None, id=0, parent=None, call=0)


def test_readers_on_hand_made_spans(monkeypatch):
    v = view()
    # self time: 100 - (20..60 u 90..100) = 50; 50 - 4 (the copy on another thread is not its)
    assert read("dispatch_self_us_p50", v) == pytest.approx((50 + 46) / 2)
    assert read("launch_us_p50", v) == pytest.approx(6.0)     # 20, 4, 6: 1500 is outside
    assert read("decode_wait_share", v) == pytest.approx(100 * 300 / 600)
    assert read("ring_wait_share", v) == pytest.approx(100 * 60 / 600)
    # the buffer: the two copies' bytes, on a clock 5 us behind the trace's
    from libflagstats_tpu_torch.bench import profiling
    mine = [recorded("lfs.stage.copy_in", 15_000, 45_000, bytes=3_000_000),
            recorded("lfs.stage.copy_in", 205_000, 215_000, bytes=1_000_000)]
    monkeypatch.setattr(profiling, "spans", lambda: mine)
    assert read("host_copy_gbps", v) == pytest.approx(4e6 / 40e-6 / 1e9)


def test_readers_return_nothing_without_their_spans(monkeypatch):
    bare = view([EVENTS[0], ev("aten::copy_", 10.0, 5.0)])
    for name in NEW:
        assert read(name, bare) is None
    from libflagstats_tpu_torch.bench import profiling
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read("host_copy_gbps", view()) is None
    monkeypatch.delattr(profiling, "to_trace_us")       # a program without the helper
    assert read("host_copy_gbps", view()) is None


def rehearse(workload, divisor=DIVISOR):
    return run.run(workload, SEED, 0.3, True, device="cpu", scale_divisor=divisor,
                   log=io.StringIO())


#: what the plain torch tier of a CPU rehearsal records: no lfs.launch,
#: and on a column no lfs.stage.*
ON_THE_CPU = {"lz4-stream": {"ring_wait_share", "decode_wait_share"},
              "column-device": {"dispatch_self_us_p50"},
              "column-blocks": {"dispatch_self_us_p50"}}


@pytest.mark.parametrize("workload", list(ON_THE_CPU))
def test_a_traced_rehearsal_reports_the_new_metrics_its_cell_names(workload):
    out = rehearse(workload)
    assert out["correct"] is True
    named = {m["name"] for m in spec.metrics(spec.benchmark(), "per_layer", workload)}
    assert set(out["metrics"]) & set(NEW) == ON_THE_CPU[workload] & named
    for name in ON_THE_CPU[workload]:
        assert out["metrics"][name]["value"] > 0


def test_a_staged_rehearsal_of_column_blocks_reports_launch_and_host_copy(monkeypatch):
    from libflagstats_tpu_torch.ops import dispatch, staging

    monkeypatch.setattr(dispatch, "auto_impl", lambda n, device=None: "cuda")
    monkeypatch.setattr(staging, "STAGE_WORDS", 1 << 15)
    out = rehearse("column-blocks", divisor=8192)
    assert out["correct"] is True
    assert {"dispatch_self_us_p50", "launch_us_p50", "host_copy_gbps"} <= set(out["metrics"])
    assert not {"ring_wait_share", "decode_wait_share"} & set(out["metrics"])
    assert all(out["metrics"][n]["value"] > 0 for n in out["metrics"])

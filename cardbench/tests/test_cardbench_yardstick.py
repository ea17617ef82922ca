"""The trace arithmetic and the metric readers on fixed event lists."""
import statistics

import pytest

from cardbench import spec
from cardbench.yardstick import (TraceView, gaps, merge, percentile, roofline_share,
                                 union_length)

KIND = "NVIDIA H100 80GB HBM3"


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


# a 1000 us window: two kernels (100 us, 50 us, overlapping a copy), two
# H2D copies of 1e6 bytes (each 20 us, overlapping each other by 10 us),
# one memset; a host op under the long gap
EVENTS = [
    ev("user_annotation", "cardbench.window", 0.0, 1000.0),
    ev("user_annotation", "cardbench.report", 0.0, 500.0),
    ev("user_annotation", "cardbench.report", 500.0, 500.0),
    ev("kernel", "stream_sums_kernel<0>", 100.0, 100.0),
    ev("kernel", "fill", 180.0, 50.0),
    ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 300.0, 20.0, bytes=1e6),
    ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 310.0, 20.0, bytes=1e6),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 900.0, 10.0, bytes=256),
    ev("gpu_memset", "Memset (Device)", 950.0, 10.0),
    ev("cpu_op", "aten::copy_", 520.0, 330.0),
    ev("kernel", "outside", 2000.0, 10.0),
]


def view(**kw):
    kw.setdefault("reports", 2)
    kw.setdefault("words", 1_000_000)
    return TraceView(EVENTS, kind=KIND, **kw)


def test_percentile_matches_statistics_inclusive():
    values = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0, 7.0]
    assert percentile(values, 0.5) == statistics.median(values)
    q = statistics.quantiles(values, n=10, method="inclusive")
    assert percentile(values, 0.9) == pytest.approx(q[8])
    assert percentile([3.0], 0.9) == 3.0
    with pytest.raises(ValueError):
        percentile([], 0.5)


def test_union_and_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (10, 12)]
    assert merge(iv) == [(0, 3), (5, 7), (10, 12)]
    assert union_length(iv, 0, 11) == 3 + 2 + 1
    assert gaps(iv, -1, 13) == [(-1, 0), (3, 5), (7, 10), (12, 13)]
    assert gaps([], 0, 4) == [(0, 4)]


def test_roofline_share():
    assert roofline_share(3.35e12, 1.0, 3.35e12) == pytest.approx(100.0)
    assert roofline_share(1e9, 2.0, 1e12) == pytest.approx(0.05)


def test_view_busy_window_and_breakdown():
    v = view()
    assert v.window_s == pytest.approx(1e-3)
    # busy: [100, 230] + [300, 330] + [900, 910] + [950, 960]
    assert v.busy_s() == pytest.approx((130 + 30 + 10 + 10) * 1e-6)
    b = v.breakdown()
    assert b["device_ops"][0] == ["stream_sums_kernel<0>", pytest.approx(100e-6)]
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(570e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def read(name, v):
    return spec.module("layer_metrics", name).read(v)


def test_layer_readers_on_fixed_events():
    v = view(sections={"decode": 0.5}, spans={"block_call": [3e-6, 1e-6, 2e-6]})
    assert read("device_idle_share", v) == pytest.approx(100 * (1 - 180 / 1000))
    least = 2e6 / 3.35e12
    assert read("kernels_roofline", v) == pytest.approx(100 * least / 150e-6)
    assert read("h2d_gbps", v) == pytest.approx(2e6 / 30e-6 / 1e9)
    assert read("decode_ms_per_report", v) == pytest.approx(250.0)
    assert read("block_call_p50_us", v) == pytest.approx(2.0)


def test_layer_readers_return_nothing_without_their_source():
    empty = TraceView([EVENTS[0]], reports=2, words=10, kind=KIND)
    for name in ("device_idle_share", "kernels_roofline", "h2d_gbps",
                 "decode_ms_per_report", "block_call_p50_us"):
        assert read(name, empty) is None
    assert read("kernels_roofline", TraceView(EVENTS, reports=2, words=10, kind="cpu")) is None

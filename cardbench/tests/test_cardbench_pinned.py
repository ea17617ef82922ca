"""The cell column-pinned (the column in page-locked host memory): the
cell's files and its one chip; CPU rehearsals that read correct, traced
and untraced; rehearsals through the staging's direct pieces that read
correct, and not correct with a direct piece dropped or shipped twice;
the readers of its two per-layer metrics on hand-made events and spans;
and, on a card, the held column pinned and the control not correct at
the cell's own size.

The CPU has no page-locked memory: the staged rehearsals mark the held
column pinned (``torch.Tensor.is_pinned``) and let the staging's rule
take the CPU for a card, as ``tests/test_torch_staging_direct.py`` does."""
import io
import json
from types import SimpleNamespace

import pytest
import torch

from cardbench import control, generator, run, spec
from cardbench.yardstick import TraceView
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import staging as ST

CELL = "column-pinned"
DIVISOR = 256
SEED = 2**31 + 5003
CONTROL_SEEDS = [3_100_000_051, 3_100_000_052, 3_100_000_053]
PIECE = 1 << 16
#: pieces of a report in a rehearsal: 3,220,862 words in pieces of PIECE,
#: 50 as in the cell's own reports
PIECES = 50


def rehearse(trace=False, seconds=0.3):
    return run.run(CELL, SEED, seconds, trace, device="cpu", scale_divisor=DIVISOR,
                   log=io.StringIO())


@pytest.fixture
def direct(monkeypatch):
    """Rehearsals count on the staging's direct path: the default impl
    on the CPU is ``"cuda"``, every CPU tensor is pinned, the rule takes
    the CPU for a card, STAGE_WORDS = PIECE. Yields the STAGED counts."""
    monkeypatch.setattr(D, "auto_impl", lambda n, device=None: "cuda")
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    real = ST.ships_direct
    monkeypatch.setattr(ST, "ships_direct",
                        lambda words, impl, device: real(words, impl, torch.device("cuda", 0)))
    monkeypatch.setattr(ST, "STAGE_WORDS", PIECE)
    return ST.STAGED


def test_the_cell_asks_for_one_chip_and_finds_its_files():
    bench = spec.benchmark()
    cell, config, traffic = spec.cell(bench, CELL)
    assert cell["chips"] == 1 and cell["config"] == "na12878-pinned"
    assert traffic == {"entry": "flagstats_u16_pinned", "holds": "pinned",
                       "about": traffic["about"]}
    assert config["column"] == {"kind": "na12878", "words": 824_541_892}
    assert config["reduced"] == [] and config["assumed"]
    assert spec.module("entries", traffic["entry"]).REFERENCE == "flagstat"
    names = {m["name"] for m in spec.metrics(bench, "per_layer", CELL)}
    assert names == {"direct_ship_share", "h2d_link_roofline"}
    assert [m["name"] for m in spec.metrics(bench, "end_to_end", CELL)] == ["words_per_s",
                                                                            "setup_s"]
    assert sum(1 for w in bench["workloads"] if w["chips"] == 4) <= max(
        1, len(bench["workloads"]) // 4)


def test_the_entry_refuses_another_holds():
    entry = spec.module("entries", "flagstats_u16_pinned")
    setup = SimpleNamespace(traffic={"holds": "card"}, program_device="cpu", log=io.StringIO())
    with pytest.raises(ValueError, match="unknown holds"):
        entry.make(torch.zeros(8, dtype=torch.int16), setup)


@pytest.mark.parametrize("trace", [False, True])
def test_a_rehearsal_reads_correct(trace):
    out = rehearse(trace)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["device"]["count"] == 1
    if trace:
        # the CPU's plain torch tier ships nothing and copies nothing
        assert out["metrics"] == {}
    else:
        assert set(out["metrics"]) == {"words_per_s", "setup_s"}
    assert json.loads(json.dumps(out)) == out


@pytest.mark.parametrize("trace", [False, True])
def test_a_rehearsal_through_the_direct_pieces_reads_correct(direct, trace):
    before = dict(direct)
    out = rehearse(trace)
    assert out["correct"] is True and out["failed"] == 0
    reports = out["attempted"] + run.WARM_REPORTS
    assert direct["direct"] - before["direct"] == direct["pieces"] - before["pieces"] \
        == PIECES * reports
    if trace:
        assert out["metrics"]["direct_ship_share"]["value"] == pytest.approx(100.0)
        assert "h2d_link_roofline" not in out["metrics"]      # no device, no copy to it


def _drop_the_second(ship, calls):
    def fn(self, slot, n, timer=None, into=None, src=None):
        out = ship(self, slot, n, timer, into, src)
        calls.append(src is not None)
        return out[:0] if src is not None and len(calls) % PIECES == 2 else out
    return fn


def _ship_twice(ship, calls):
    def fn(self, slot, n, timer=None, into=None, src=None):
        out = ship(self, slot, n, timer, into, src)
        calls.append(src is not None)
        return torch.cat([out, out]) if src is not None and len(calls) % PIECES == 2 else out
    return fn


@pytest.mark.parametrize("fault", [_drop_the_second, _ship_twice])
def test_a_broken_direct_piece_reads_not_correct(direct, monkeypatch, fault):
    """Every report ships PIECES direct pieces; the second of each is
    lost or counted twice."""
    calls = []
    monkeypatch.setattr(ST._Ring, "ship", fault(ST._Ring.ship, calls))
    out = rehearse()
    assert all(calls) and len(calls) % PIECES == 0
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1
    assert out["checks"]["counter_gap_max"]["value"] > 0


def test_the_control_reads_correct_at_a_small_size():
    out = run.run(CELL, SEED, 0.2, False, device="cpu", scale_divisor=DIVISOR, control=True,
                  log=io.StringIO())
    assert out["correct"] is True


def ev(name, ts, dur, cat="user_annotation", nbytes=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": {}}
    if nbytes is not None:
        e["args"]["bytes"] = nbytes
    return e


HTOD = "Memcpy HtoD (Pinned -> Device)"
# a 2000 us window of two reports of 40,000 words; the program's ship
# spans (the third lies past the window) and two copies on the card
EVENTS = [
    ev("cardbench.window", 0.0, 2000.0),
    ev("lfs.stage.ship", 100.0, 10.0, cat="cpu_op"),
    ev("lfs.stage.ship", 1100.0, 10.0, cat="cpu_op"),
    ev("lfs.stage.ship", 2500.0, 10.0, cat="cpu_op"),
    ev(HTOD, 120.0, 500.0, cat="gpu_memcpy", nbytes=80_000),
    ev(HTOD, 1120.0, 500.0, cat="gpu_memcpy", nbytes=80_000),
]


def recorded(name, start_ns, end_ns, **args):
    return SimpleNamespace(name=name, start_ns=start_ns, end_ns=end_ns, traced=True,
                           args=args, thread=1, thread_name=None, id=0, parent=None, call=0)


def read(name, events, words=80_000):
    return spec.module("layer_metrics", name).read(TraceView(events, reports=2, words=words,
                                                             kind="cpu"))


@pytest.mark.parametrize("sources,want", [(("caller", "caller", "caller"), 100.0),
                                          (("caller", "slot", "caller"), 75.0),
                                          ((None, None, None), 0.0)])
def test_direct_ship_share_on_hand_made_spans(monkeypatch, sources, want):
    """Bytes shipped from the caller's memory over all shipped bytes in
    the window, the spans on a clock 5 us behind the trace's; a span
    without ``source`` (the parent's) is a slot's."""
    from libflagstats_tpu_torch.bench import profiling

    mine = [recorded("lfs.stage.ship", (ts - 5) * 1000, (ts + 5) * 1000, bytes=b,
                     **({} if s is None else {"source": s}))
            for ts, b, s in zip((100, 1100, 2500), (30_000, 10_000, 50_000), sources)]
    monkeypatch.setattr(profiling, "spans", lambda: mine)
    # the first two lie in the window: 30,000 and 10,000 bytes
    assert read("direct_ship_share", EVENTS) == pytest.approx(want)


def test_h2d_link_roofline_on_a_hand_made_trace():
    # 160,000 bytes at 63.015 GB/s over the 2000 us window
    link = 32e9 * 16 * 128 / 130 / 8
    assert read("h2d_link_roofline", EVENTS) == pytest.approx(100 * 160_000 / link / 2e-3)


def test_readers_find_nothing_where_there_is_nothing_to_read(monkeypatch):
    bare = [EVENTS[0], ev("aten::copy_", 10.0, 5.0, cat="cpu_op")]
    assert read("direct_ship_share", bare) is None
    assert read("h2d_link_roofline", bare) is None
    assert read("h2d_link_roofline", EVENTS, words=0) is None
    from libflagstats_tpu_torch.bench import profiling
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read("direct_ship_share", EVENTS) is None
    monkeypatch.delattr(profiling, "to_trace_us")       # a program without the helper
    assert read("direct_ship_share", EVENTS) is None


@pytest.mark.card
def test_the_held_column_is_pinned_and_the_control_reads_not_correct(card, capsys):
    bench = spec.benchmark()
    _, config, traffic = spec.cell(bench, CELL)
    import contextlib

    with contextlib.ExitStack() as stack:
        setup = generator.Setup(config, traffic, generator.Probe(), None, stack, io.StringIO())
        prep = generator.prepare(setup, CONTROL_SEEDS[0], card, scale_divisor=64)
        assert prep.held.device.type == "cpu" and prep.held.is_pinned()
        assert prep.held.shape[0] == prep.words
    assert control.main(["--workload", CELL, "--seeds", *map(str, CONTROL_SEEDS)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    with capsys.disabled():
        for line in lines:
            print(json.dumps(line))
    assert len(lines) == 3 and not any(x["correct"] for x in lines)

"""The cell column-sharded4 (the column as four shards, one a card): CPU
rehearsals that read correct, and not correct with the program broken
underneath (the merge dropping one shard's sums, and the faults the
other cells are held to); the readers of its three per-layer metrics on
a hand-made trace of four cards; the cell's four chips; and, on a host
with four cards, the control at the cell's own size."""
import io
import json

import numpy as np
import pytest
import torch

import libflagstats_tpu_torch as lft
from cardbench import control, run, spec
from cardbench.yardstick import TraceView
from libflagstats_tpu_torch.ops import staging as ST

CELL = "column-sharded4"
DIVISOR = 256
SEED = 2**31 + 4099
CONTROL_SEEDS = [3_100_000_041, 3_100_000_042, 3_100_000_043]


def rehearse(trace=False, seconds=0.3):
    return run.run(CELL, SEED, seconds, trace, device="cpu", scale_divisor=DIVISOR,
                   log=io.StringIO())


def test_the_cell_asks_for_four_chips_and_finds_its_files():
    bench = spec.benchmark()
    cell, config, traffic = spec.cell(bench, CELL)
    assert cell["chips"] == 4 and traffic["shards"] == 4 and traffic["holds"] == "cards"
    assert sum(1 for w in bench["workloads"] if w["chips"] == 4) <= max(
        1, len(bench["workloads"]) // 4)
    assert sum(config["shards"]["words"]) == config["column"]["words"]
    assert [2 * w for w in config["shards"]["words"]] == config["shards"]["bytes_per_card"]
    names = {m["name"] for m in spec.metrics(bench, "per_layer", CELL)}
    assert names == {"merge_us_p50", "shard_fanout_us_p50", "card_idle_share"}
    assert [m["name"] for m in spec.metrics(bench, "end_to_end", CELL)] == ["words_per_s",
                                                                            "setup_s"]


@pytest.mark.parametrize("trace", [False, True])
def test_a_rehearsal_reads_correct(trace):
    out = rehearse(trace)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["device"]["count"] == 4
    if trace:
        assert out["metrics"]["merge_us_p50"]["value"] > 0
    assert json.loads(json.dumps(out)) == out


def test_a_merge_that_drops_a_shard_reads_not_correct(monkeypatch):
    take = ST.Tally.take

    def drop_the_second_shard(self, others):
        take(self, list(others)[1:])   # the first of each call's three peers is lost
    monkeypatch.setattr(ST.Tally, "take", drop_the_second_shard)
    out = rehearse()
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1
    assert out["checks"]["counter_gap_max"]["value"] > 0


def _half(orig):
    return lambda shards, **kw: orig([s[: len(s) // 2] for s in shards], **kw)


def _altered(orig):
    def fn(*a, **kw):
        r = orig(*a, **kw)
        r[12] += 1
        return r
    return fn


FAULTS = {"state_unchanged": lambda orig: lambda *a, **kw: np.zeros(32, np.uint64),
          "half_left_out": _half, "answer_altered": _altered}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_program_reads_not_correct(fault, monkeypatch):
    monkeypatch.setattr(lft, "flagstat_sharded", FAULTS[fault](lft.flagstat_sharded))
    out = rehearse()
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1


def test_the_reference_holds_the_flagstat_references_table_and_counts():
    shards_ref, column_ref = (spec.module("references", n) for n in ("flagstat_shards",
                                                                      "flagstat"))
    np.testing.assert_array_equal(shards_ref.value_table(), column_ref.value_table())
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 16, 300_001, dtype=np.uint16)
    cuts = [0, 70_000, 70_000, 250_001, 300_001]      # an empty shard among them
    shards = [torch.from_numpy(words[a:b].view(np.int16)) for a, b in zip(cuts, cuts[1:])]
    want = column_ref.exact(words, "cpu")
    np.testing.assert_array_equal(shards_ref.exact(shards, "cpu"), want)
    np.testing.assert_array_equal(shards_ref.control(shards, "cpu"), want)


def test_the_control_reads_correct_at_a_small_size():
    out = run.run(CELL, SEED, 0.2, False, device="cpu", scale_divisor=DIVISOR, control=True,
                  log=io.StringIO())
    assert out["correct"] is True


def ev(name, ts, dur, cat="user_annotation", device=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": {}}
    if device is not None:
        e["args"]["device"] = device
    return e


K1 = "void stream_sums_kernel<(Mode)0>(unsigned short const*, long, unsigned long long*)"

# a 1000 us window, two reports; card c's K1 of report 1 starts at
# 110 + 30c, of report 2 at 510 + 20c (card 3: 580); card 0 also runs an
# epilogue kernel before report 1's count, card 3 a memset after its
# first K1; the device's own copy of a report's span is not a report
FOUR_CARDS = [
    ev("cardbench.window", 0.0, 1000.0),
    ev("cardbench.report", 40.0, 400.0),
    ev("cardbench.report", 500.0, 300.0),
    ev("cardbench.report", 40.0, 900.0, cat="gpu_user_annotation", device=0),
    ev("lfs.shard.merge", 300.0, 20.0),
    ev("lfs.shard.merge", 700.0, 30.0),
    ev("lfs.shard.merge", 300.0, 500.0, cat="gpu_user_annotation", device=0),
    ev("epilogue_kernel", 50.0, 10.0, cat="kernel", device=0),
    ev("Memset (Device)", 300.0, 100.0, cat="gpu_memset", device=3),
] + [ev(K1, 110.0 + 30 * c, 100.0, cat="kernel", device=c) for c in range(4)] \
  + [ev(K1, 510.0 + 20 * c if c < 3 else 580.0, 100.0, cat="kernel", device=c)
     for c in range(4)]


def read(name, events):
    return spec.module("layer_metrics", name).read(TraceView(events, reports=2, words=1000,
                                                             kind="cpu"))


def test_readers_on_a_hand_made_trace_of_four_cards():
    assert read("merge_us_p50", FOUR_CARDS) == pytest.approx(25.0)
    assert read("shard_fanout_us_p50", FOUR_CARDS) == pytest.approx((90.0 + 70.0) / 2)
    # busy: card 0 210 us, cards 1-2 200, card 3 300 of the 1000 us window
    assert read("card_idle_share", FOUR_CARDS) == pytest.approx((79 + 80 + 80 + 70) / 4)


def test_readers_find_nothing_where_there_is_nothing_to_read():
    window = [FOUR_CARDS[0], FOUR_CARDS[1]]
    for name in ("merge_us_p50", "shard_fanout_us_p50", "card_idle_share"):
        assert read(name, window) is None
    one_card = window + [ev(K1, 100.0, 50.0, cat="kernel", device=0)]
    assert read("shard_fanout_us_p50", one_card) is None
    assert read("card_idle_share", one_card) == pytest.approx(95.0)


@pytest.mark.card
def test_the_control_reads_not_correct_at_the_cells_size(card, capsys):
    if torch.cuda.device_count() < 4:
        pytest.skip(f"the cell needs 4 cards; {torch.cuda.device_count()} found")
    assert control.main(["--workload", CELL, "--seeds", *map(str, CONTROL_SEEDS)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    with capsys.disabled():
        for line in lines:
            print(json.dumps(line))
    assert len(lines) == 3 and not any(x["correct"] for x in lines)

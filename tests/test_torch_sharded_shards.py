"""flagstat_sharded's list form (parallel/sharded.py): shards counted
where they lie, here over k CPU device entries, against the JAX
package's flagstat_sharded of their concatenation on conftest's 8-device
CPU mesh, flagstat_numpy, and the benchmark's plain reference
``flagstat_shards``; the shards' partial sums add to the column's; the
checks on shards and devices; the card path's launches, peer copies and
one epilogue, taken on the CPU by tallies that believe they are on a
card (as tests/test_torch_epilogue.py does); the counters SHARDED and
the spans. Exact (tolerance 0)."""
import threading

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libflagstats_tpu import flags as jF
from libflagstats_tpu.parallel import sharded as jS

import libflagstats_tpu_torch as L
from cardbench import spec
from libflagstats_tpu_torch.bench import profiling as P
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import staging as ST
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.parallel import sharded as S

REFERENCE = spec.module("references", "flagstat_shards")
REPORT_ZEROS = [1, 3, 4, 5, 17, 19, 20, 21]
PIECE = 4096
CARD_IMPLS = ("cuda", "cuda_pre", "cuda_words")
#: shard lengths a k: uneven, a shard of 0 words, ragged against a piece,
#: a transpose group and 8 words
LAYOUTS = {1: [70_001], 2: [0, 70_001 + 65_536], 4: [65_536 + 5, 0, 3, 40_000]}


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices (virtual CPU mesh)")
    return jS.data_mesh()


def column(k: int, seed: int = 0) -> np.ndarray:
    return generate_flags(sum(LAYOUTS[k]), seed=100 + k + seed, full_range=True)


def shards_of(x: np.ndarray, lengths) -> list[torch.Tensor]:
    """Consecutive shards of ``x``, every other one a uint16 tensor and
    the rest int16 views."""
    cuts = np.cumsum([0] + list(lengths))
    out = []
    for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        part = np.ascontiguousarray(x[a:b])
        out.append(torch.from_numpy(part if i % 2 else part.view(np.int16)))
    return out


def check(got, want, report: bool, impl: str) -> None:
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    if report and impl in ("cuda", "cuda_pre"):     # the 21-stream report kernels
        idx = list(jF.REPORT_COUNTERS)
        np.testing.assert_array_equal(got[idx], want[idx])
        assert not got[REPORT_ZEROS].any()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("report", [False, True])
@pytest.mark.parametrize("impl", S.SHARDED_IMPLS)
@pytest.mark.parametrize("k", sorted(LAYOUTS))
def test_shards_equal_jax_the_oracle_and_the_reference(mesh, k, impl, report):
    x = column(k)
    shards = shards_of(x, LAYOUTS[k])
    got = S.flagstat_sharded(shards, impl=impl, report=report)
    assert got.dtype == np.uint64 and got.shape == (32,)
    want = jS.flagstat_sharded(x, mesh=mesh, impl="xla", report=report)
    check(got, want, report, impl)
    check(got, flagstat_numpy(x), report, impl)
    check(got, REFERENCE.exact(shards, "cpu"), report, impl)
    # the same list through the package's top-level name, and as a tuple
    # with its devices given
    again = L.flagstat_sharded(tuple(shards), devices=["cpu"] * k, impl=impl, report=report)
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("impl", S.SHARDED_IMPLS)
def test_partial_sums_add_to_the_columns(impl):
    x = column(4, seed=1)
    parts = [S.sharded_sums(s, [torch.device("cpu")], impl) for s in shards_of(x, LAYOUTS[4])]
    total, fail = S.sharded_sums(torch.from_numpy(x.view(np.int16)), [torch.device("cpu")], impl)
    np.testing.assert_array_equal(sum(t for t, _ in parts), total)
    np.testing.assert_array_equal(sum(f for _, f in parts), fail)


def test_shards_past_device_word_cap_go_in_rounds(monkeypatch):
    """A shard past a shrunk DEVICE_WORD_CAP goes in rounds, one count a
    round; a short shard beside it takes one."""
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 20_000)
    x = column(4, seed=2)
    shards = shards_of(x, LAYOUTS[4])
    seen = []
    real = S._local_sums
    monkeypatch.setattr(S, "_local_sums",
                        lambda pairs, impl: seen.append([w.numel() for w, _ in pairs])
                        or real(pairs, impl))
    np.testing.assert_array_equal(S.flagstat_sharded(shards, impl="torch"), flagstat_numpy(x))
    assert sum(map(sum, seen)) == x.size
    # rounds of 4, 2, 1 and 1 shards: the first shard's 65,541 words take
    # four, the last's 40,000 two
    assert [len(r) for r in seen] == [4, 2, 1, 1]
    assert max(n for r in seen for n in r) == 20_000


def test_bad_shards_and_devices_raise():
    x = column(2)
    shards = shards_of(x, LAYOUTS[2])
    with pytest.raises(ValueError, match="not the shards' devices"):
        S.flagstat_sharded(shards, devices=["cpu"] * 3, impl="torch")
    with pytest.raises(ValueError, match="not the shards' devices"):
        S.flagstat_sharded(shards, devices=["cpu"], impl="torch")
    with pytest.raises(ValueError, match="shard 1"):
        S.flagstat_sharded([shards[0], torch.zeros(5, dtype=torch.int32)], impl="torch")
    with pytest.raises(ValueError, match="shard 0"):
        S.flagstat_sharded([torch.zeros((2, 4), dtype=torch.int16)], impl="torch")
    with pytest.raises(ValueError, match="shard 1"):
        S.flagstat_sharded([shards[0], x[:10]], impl="torch")
    with pytest.raises(ValueError, match="unknown sharded impl"):
        S.flagstat_sharded(shards, impl="cuda_report")
    # with no impl, the first shard's device picks the tier: the CPU's
    np.testing.assert_array_equal(S.flagstat_sharded(shards), flagstat_numpy(x))


@pytest.fixture
def card_path(monkeypatch):
    """Tallies of the kernel impls take their card path on the CPU: the
    wrappers add into the accumulator in place (their plain versions),
    each epilogue launch goes to the plain twin and is counted in
    LAUNCHES["epilogue"] as the kernel's is, and ``assemble_counters``
    raises. Returns the list of counts each launched wrapper saw."""
    seen = []
    init = ST.Tally.__init__

    def card_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.card = self.impl != "torch"
    monkeypatch.setattr(S, "_KEPT", threading.local())   # no tally of another test

    def epilogue(acc, kind, n=None, out=None, host=None, done=None):
        K.LAUNCHES["epilogue"] += 1
        return K.epilogue_plain(acc, kind, n)

    def counters(acc, kind, n, timer=None):
        return epilogue(acc, kind, n).numpy().astype(np.uint64)

    def no_assembly(*a, **kw):
        raise AssertionError("assemble_counters on the card path")

    real = {"cuda": K.stream_sums_cuda, "pre": K.stream_sums_pre_cuda,
            "words": ST.stream_sums_words_cuda}

    def spy(key, size):
        def wrapper(x, *args, **kwargs):
            if size(x):
                seen.append(size(x))
            return real[key](x, *args, **kwargs)
        return wrapper

    monkeypatch.setattr(ST.Tally, "__init__", card_init)
    monkeypatch.setattr(K, "epilogue_cuda", epilogue)
    monkeypatch.setattr(K, "counters_cuda", counters)
    monkeypatch.setattr(ST, "assemble_counters", no_assembly)
    monkeypatch.setattr(K, "stream_sums_cuda", spy("cuda", lambda x: x.numel()))
    monkeypatch.setattr(K, "stream_sums_pre_cuda",
                        spy("pre", lambda t: t.shape[0] * K.GROUP_WORDS))
    monkeypatch.setattr(ST, "stream_sums_words_cuda", spy("words", lambda x: x.numel()))
    monkeypatch.setattr(ST, "STAGE_WORDS", PIECE)
    return seen


def _pieces(lengths, impl: str) -> int:
    step = K.GROUP_WORDS if impl == "cuda_pre" else PIECE
    return sum(-(-n // step) for n in lengths)


@pytest.mark.parametrize("report", [False, True])
@pytest.mark.parametrize("impl", CARD_IMPLS)
@pytest.mark.parametrize("k", sorted(LAYOUTS))
def test_card_path_one_count_a_piece_k_minus_1_copies_one_epilogue(card_path, k, impl, report):
    x = column(k, seed=3)
    shards = shards_of(x, LAYOUTS[k])
    before = dict(S.SHARDED), K.LAUNCHES["epilogue"]
    got = S.flagstat_sharded(shards, impl=impl, report=report)
    check(got, flagstat_numpy(x), report, impl)
    assert len(card_path) == _pieces(LAYOUTS[k], impl)
    assert K.LAUNCHES["epilogue"] - before[1] == 1
    assert {key: S.SHARDED[key] - v for key, v in before[0].items()} == \
        {"calls": 1, "shards": k, "peer_copies": k - 1}


@pytest.mark.parametrize("impl", CARD_IMPLS)
def test_card_path_of_one_column_ends_the_same_way(card_path, impl):
    """The one-column form, split over three device entries: one count a
    staged piece, two peer copies, one epilogue and no host assembly."""
    x = column(4, seed=4)
    before = dict(S.SHARDED), K.LAUNCHES["epilogue"]
    got = S.flagstat_sharded(x, devices=["cpu"] * 3, impl=impl)
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    lengths = [b - a for a, b in S.shard_bounds(x.size, 3, impl)]
    assert len(card_path) == _pieces(lengths, impl)
    assert K.LAUNCHES["epilogue"] - before[1] == 1
    assert S.SHARDED["peer_copies"] - before[0]["peer_copies"] == 2


def test_a_thread_keeps_its_tallies_for_its_next_count_over_the_same_devices():
    x = column(4, seed=6)
    shards = shards_of(x, LAYOUTS[4])
    first = S._tallies(["cpu"] * 4, "cuda", False)
    np.testing.assert_array_equal(S.flagstat_sharded(shards, impl="cuda"), flagstat_numpy(x))
    again = S._tallies(["cpu"] * 4, "cuda", False)
    assert [id(t) for t in again] == [id(t) for t in first]
    assert all(t.fresh for t in again)
    assert S._tallies(["cpu"] * 4, "cuda", True)[0] is not first[0]
    assert len(S._tallies(["cpu"] * 2, "cuda", False)) == 2
    # a count that follows one over other data starts from zero
    y = column(4, seed=7)
    np.testing.assert_array_equal(S.flagstat_sharded(shards_of(y, LAYOUTS[4]), impl="cuda"),
                                  flagstat_numpy(y))


def test_take_refuses_another_kind_of_count():
    a, b = ST.Tally("cuda", "cpu"), ST.Tally("cuda", "cpu", report=True)
    with pytest.raises(ValueError, match="cannot add"):
        a.take([b])
    with pytest.raises(ValueError, match="cannot add"):
        a.take([ST.Tally("cuda", "cpu"), ST.Tally("cuda_words", "cpu")])


@pytest.mark.parametrize("form", ["shards", "column"])
def test_each_call_records_its_entry_and_merge_spans(form):
    x = column(4, seed=5)
    arg = shards_of(x, LAYOUTS[4]) if form == "shards" else x
    P.clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                got = S.flagstat_sharded(arg, devices=["cpu"] * 4, impl="cuda")
        spans = P.spans()
    finally:
        P.clear_spans()
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    calls = [s for s in spans if s.name == "lfs.flagstat_sharded"]
    merges = [s for s in spans if s.name == "lfs.shard.merge"]
    assert len(calls) == len(merges) == 2
    assert [c.args for c in calls] == [{"shards": 4, "words": x.size, "impl": "cuda"}] * 2
    assert [m.args for m in merges] == [{"peers": 3}] * 2
    assert [m.parent for m in merges] == [c.id for c in calls]

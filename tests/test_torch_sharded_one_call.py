"""The native count of ``flagstat_sharded``'s list form
(``parallel/sharded._native_cards``, ``_Native``): two native calls,
``lfs_sharded_counts`` and ``lfs_sharded_merge``, and one wait.

On the CPU both native entries are replaced by fakes that record their
arguments and do their work on the CPU memory behind them: each card's
memset and K1's sums by the plain version, the copy of the other cards'
sums into the rows, and the merge-epilogue by the epilogue's plain twin
over the summed rows into ``out`` and the pinned buffer. Four fake cards
are registered: a shard is "on card i" when its storage was registered
there. The tests check where the path engages (two to four different
cards, either mode, uneven and empty shards) and where it does not (a
repeated card, one word past DEVICE_WORD_CAP, the other impls, the column
form, one shard, the CPU), the counters against ``flagstat_numpy``, the
counts of ``ONE_CALL``, ``SHARDED`` and ``LAUNCHES``, the spans the
benchmark reads, that a merge which drops a peer's row is caught, and
that a thread's second count reuses its buffers and starts from zero.

The tests marked ``card`` run on two or more CUDA cards and skip below
(``python3 -m pytest tests/test_torch_sharded_one_call.py -m card
--noconftest``; this file imports no JAX)."""
import ctypes
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.bench import profiling as P
from libflagstats_tpu_torch.ops import cuda_build
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.parallel import sharded as S

CAP = 5000            # DEVICE_WORD_CAP in the fake world
STREAM = 0x5EED0      # card i's raw stream handle in the fake world is STREAM + i
DONE = 0xD0E          # every fake scratch's event handle
PEER_EVENT = 0xE70    # the fake peer events' handles start here
REPORT_ZEROS = [1, 3, 4, 5, 17, 19, 20, 21]
#: shard lengths: uneven, an empty shard, ragged against 8 words
LAYOUTS = {2: [3001, 1999], 3: [1200, 0, 2777], 4: [4000, 7, 0, 2501]}
#: the cards the shards of each layout lie on, the first not card 0
CARDS = {2: [1, 0], 3: [2, 0, 3], 4: [3, 1, 0, 2]}


def check(got, x: np.ndarray, report: bool = False) -> None:
    got, want = np.asarray(got, np.int64), flagstat_numpy(x).astype(np.int64)
    if report:
        idx = list(F.REPORT_COUNTERS)
        np.testing.assert_array_equal(got[idx], want[idx])
        assert not got[REPORT_ZEROS].any()
    else:
        np.testing.assert_array_equal(got, want)


def at(ptr: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The ``n`` entries of ``dtype`` at the CPU address ``ptr``."""
    if not n:
        return torch.empty(0, dtype=dtype)
    size = n * torch.empty(0, dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * size).from_address(ptr), dtype=dtype)


def kind_of(emap) -> str:
    """The accumulator kind whose map ``emap`` is."""
    got = (tuple(emap.c), tuple(emap.c2), tuple(emap.f))
    (kind,) = [k for k in ("flagstat", "flagstat_report") if K.epilogue_map(k) == got]
    assert emap.qc == F.FQCFAIL_OFF
    return kind


class Event:
    """A fake card event: counts its waits."""

    def __init__(self, handle: int):
        self.cuda_event = handle
        self.waits = 0

    def synchronize(self) -> None:
        self.waits += 1


class Scratch:
    """A thread's fake ``kernels._Scratch`` of one card, in CPU memory."""

    def __init__(self):
        self.acc = torch.full((max(K.RAW_STREAMS.values()),), -1, dtype=torch.int64)
        self.out = torch.empty(F.N_COUNTERS, dtype=torch.int64)
        self.host = torch.empty(F.N_COUNTERS, dtype=torch.int64)
        self.host_np = self.host.numpy()
        self.done = Event(DONE)


class FakeCards:
    """The fake world's four cards: the shards registered on each, a
    scratch per thread and card, and the two native entries, which record
    each call's arguments. ``drop`` makes the merge leave out that peer's
    row."""

    def __init__(self):
        self.on: dict[int, int] = {}
        self.scratches: dict = {}
        self.calls: list[dict] = []
        self.buffers: list = []
        self.drop = None

    def shard(self, x: np.ndarray, card: int) -> torch.Tensor:
        """A shard of the words ``x`` "on card ``card``" (an empty one a
        view of a storage of its own, as an empty slice of a card's
        column is)."""
        t = torch.zeros(max(x.size, 1), dtype=torch.int16)
        t[:x.size] = torch.from_numpy(np.ascontiguousarray(x).view(np.int16))
        self.on[t.untyped_storage().data_ptr()] = card
        return t[:x.size]

    def card(self, shard):
        index = self.on.get(shard.untyped_storage().data_ptr())
        return None if index is None else torch.device("cuda", index)

    def scratch(self, dev) -> Scratch:
        key = (threading.get_ident(), dev)
        if key not in self.scratches:
            self.scratches[key] = Scratch()
        return self.scratches[key]

    def card_buffers(self, cards, sums):
        rows = torch.full((len(cards) - 1, sums), -1, dtype=torch.int64)
        events = [Event(PEER_EVENT + d.index) for d in cards[1:]]
        self.buffers.append((rows, events))
        return rows, events

    def counts(self, k, mode, devices, words, n, accs, rows, events, streams):
        kind = K.MODES[mode]
        sums = K.RAW_STREAMS[kind]
        self.calls.append(dict(entry="lfs_sharded_counts", k=k, mode=kind,
                               devices=devices[:k], words=[w or 0 for w in words[:k]],
                               n=n[:k], accs=accs[:k], rows=rows, events=events[:k - 1],
                               streams=streams[:k]))
        for i in range(k):
            acc = at(accs[i], sums, torch.int64)
            acc.zero_()                                                # the memset
            acc += K.stream_sums_plain(at(words[i] or 0, n[i], torch.int16), kind)   # K1
            if i:
                at(rows + (i - 1) * sums * 8, sums, torch.int64).copy_(acc)   # the peer copy
        return 0

    def merge(self, device, acc, rows, peers, stride, emap, n, out, host, events, done,
              stream):
        kind = kind_of(emap)
        self.calls.append(dict(entry="lfs_sharded_merge", device=device, acc=acc, rows=rows,
                               peers=peers, stride=stride, mode=kind, n=n, out=out, host=host,
                               events=events[:peers], done=done, stream=stream))
        assert stride == K.RAW_STREAMS[kind]
        total = at(acc, stride, torch.int64).clone()
        for p in range(peers):
            if p != self.drop:
                total += at(rows + p * stride * 8, stride, torch.int64)
        counters = K.epilogue_plain(total, kind, n)
        at(out, F.N_COUNTERS, torch.int64).copy_(counters)
        at(host, F.N_COUNTERS, torch.int64).copy_(counters)
        return 0


@pytest.fixture
def cards(monkeypatch):
    """The fake world: four cards, the two native entries, the scratch,
    the card buffers and the raw streams faked; no kept buffers of
    another test; DEVICE_WORD_CAP = CAP."""
    fake = FakeCards()
    monkeypatch.setattr(S, "_card", fake.card)
    monkeypatch.setattr(S, "_card_buffers", fake.card_buffers)
    monkeypatch.setattr(S, "_KEPT", threading.local())
    monkeypatch.setattr(K, "scratch", fake.scratch)
    monkeypatch.setattr(K, "raw_stream", lambda dev: STREAM + dev.index)
    monkeypatch.setattr(cuda_build, "load", lambda: SimpleNamespace(
        lfs_sharded_counts=fake.counts, lfs_sharded_merge=fake.merge))
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", CAP)
    return fake


def column(k: int, seed: int = 0) -> np.ndarray:
    return generate_flags(sum(LAYOUTS[k]), seed=300 + k + seed, full_range=True)


def shards_on(fake: FakeCards, x: np.ndarray, lengths, cards) -> list[torch.Tensor]:
    cuts = np.cumsum([0] + list(lengths))
    return [fake.shard(x[a:b], c) for a, b, c in zip(cuts[:-1], cuts[1:], cards)]


def counted(fn):
    """(fn's result, what it added to ONE_CALL, SHARDED and LAUNCHES)."""
    before = (dict(S.ONE_CALL), dict(S.SHARDED), dict(K.LAUNCHES))
    got = fn()
    after = (S.ONE_CALL, S.SHARDED, K.LAUNCHES)
    return got, [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]


@pytest.mark.parametrize("report", [False, True])
@pytest.mark.parametrize("k", sorted(LAYOUTS))
def test_shards_on_different_cards_are_two_native_calls(cards, k, report):
    x = column(k)
    shards = shards_on(cards, x, LAYOUTS[k], CARDS[k])
    got, (one, sharded, launches) = counted(
        lambda: L.flagstat_sharded(shards, impl="cuda", report=report))
    check(got, x, report)
    assert got.dtype == np.uint64 and got.shape == (32,)
    mode = "flagstat_report" if report else "flagstat"
    devs = [torch.device("cuda", c) for c in CARDS[k]]
    scratch = [cards.scratch(d) for d in devs]
    (rows, events), = cards.buffers
    assert [c["entry"] for c in cards.calls] == ["lfs_sharded_counts", "lfs_sharded_merge"]
    counts, merge = cards.calls
    assert counts == dict(entry="lfs_sharded_counts", k=k, mode=mode, devices=CARDS[k],
                          words=[s.data_ptr() for s in shards], n=LAYOUTS[k],
                          accs=[s.acc.data_ptr() for s in scratch], rows=rows.data_ptr(),
                          events=[e.cuda_event for e in events],
                          streams=[STREAM + c for c in CARDS[k]])
    assert merge == dict(entry="lfs_sharded_merge", device=CARDS[k][0],
                         acc=scratch[0].acc.data_ptr(), rows=rows.data_ptr(), peers=k - 1,
                         stride=K.RAW_STREAMS[mode], mode=mode, n=x.size,
                         out=scratch[0].out.data_ptr(), host=scratch[0].host.data_ptr(),
                         events=[PEER_EVENT + c for c in CARDS[k][1:]], done=DONE,
                         stream=STREAM + CARDS[k][0])
    assert tuple(rows.shape) == (k - 1, K.RAW_STREAMS[mode])
    assert scratch[0].done.waits == 1
    assert one == {"calls": 1}
    assert sharded == {"calls": 1, "shards": k, "peer_copies": k - 1}
    assert {key: v for key, v in launches.items() if v} == {
        mode: sum(n > 0 for n in LAYOUTS[k]), "epilogue": 1}


def test_every_shard_empty_counts_nothing(cards):
    shards = [cards.shard(np.zeros(0, np.uint16), c) for c in (0, 1, 2)]
    got, (one, _, launches) = counted(lambda: L.flagstat_sharded(shards, impl="cuda"))
    check(got, np.zeros(0, np.uint16))
    assert one == {"calls": 1}
    assert {key: v for key, v in launches.items() if v} == {"epilogue": 1}


@pytest.mark.parametrize("case", ["a repeated card", "a shard one word past the cap",
                                  "cuda_pre", "cuda_words", "torch", "the column form",
                                  "one shard", "the CPU"])
def test_the_general_path_takes_every_other_count(cards, case):
    k = 4
    x = column(k, seed=1)
    lengths, on, impl = list(LAYOUTS[k]), list(CARDS[k]), "cuda"
    if case == "a repeated card":
        on[2] = on[0]
    elif case == "a shard one word past the cap":
        lengths = [CAP + 1, 0, 3, 40]
        x = generate_flags(sum(lengths), seed=11, full_range=True)
    elif case in ("cuda_pre", "cuda_words", "torch"):
        impl = case
    elif case == "one shard":
        lengths, on = [x.size], [2]
    if case == "the column form":
        call = lambda: L.flagstat_sharded(x, devices=["cpu"] * k, impl=impl)   # noqa: E731
    else:
        shards = shards_on(cards, x, lengths, on)
        if case == "the CPU":
            shards = [s.clone() for s in shards]    # storages on no card
        call = lambda: L.flagstat_sharded(shards, impl=impl)   # noqa: E731
    got, (one, sharded, _) = counted(call)
    check(got, x)
    assert cards.calls == [] and cards.buffers == [] and one == {"calls": 0}
    assert sharded["calls"] == 1


def test_a_shard_at_the_cap_engages(cards):
    x = generate_flags(CAP + 9, seed=12, full_range=True)
    shards = shards_on(cards, x, [CAP, 9], [0, 1])
    got, (one, _, _) = counted(lambda: L.flagstat_sharded(shards, impl="cuda"))
    check(got, x)
    assert one == {"calls": 1} and len(cards.calls) == 2


@pytest.mark.parametrize("drop", [0, 2])
def test_a_merge_that_drops_a_peers_row_gives_wrong_counters(cards, drop):
    x = column(4, seed=2)
    shards = shards_on(cards, x, LAYOUTS[4], CARDS[4])
    check(L.flagstat_sharded(shards, impl="cuda"), x)
    cards.drop = drop
    got = L.flagstat_sharded(shards, impl="cuda")
    with pytest.raises(AssertionError):
        check(got, x)


def test_a_second_count_reuses_the_kept_buffers_and_starts_from_zero(cards):
    x, y = column(3, seed=3), column(3, seed=4)
    xs, ys = shards_on(cards, x, LAYOUTS[3], CARDS[3]), shards_on(cards, y, LAYOUTS[3], CARDS[3])
    first = L.flagstat_sharded(xs, impl="cuda")
    kept = S._KEPT.native[1]
    second = L.flagstat_sharded(ys, impl="cuda")
    check(first, x)
    check(second, y)
    assert S._KEPT.native[1] is kept and len(cards.buffers) == 1
    a, b = cards.calls[0], cards.calls[2]
    assert (a["accs"], a["rows"], a["events"]) == (b["accs"], b["rows"], b["events"])
    assert a["words"] != b["words"]
    # another mode, or other cards, builds its own; the general path keeps its tallies
    L.flagstat_sharded(shards_on(cards, x, LAYOUTS[3], CARDS[3]), impl="cuda", report=True)
    assert len(cards.buffers) == 2 and S._KEPT.native[1] is not kept
    L.flagstat_sharded(shards_on(cards, x, LAYOUTS[3], [0, 1, 2]), impl="cuda")
    assert len(cards.buffers) == 3


def test_each_thread_keeps_its_own_buffers(cards):
    xs = [column(4, seed=10 + i) for i in range(3)]
    got, errors = {}, []

    def work(i):
        try:
            for _ in range(3):
                got[i] = L.flagstat_sharded(shards_on(cards, xs[i], LAYOUTS[4], CARDS[4]),
                                            impl="cuda")
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert errors == [] and len(cards.buffers) == len(xs)
    for i, x in enumerate(xs):
        check(got[i], x)


def test_spans_are_those_the_benchmark_reads(cards):
    k = 4
    x = column(k, seed=5)
    shards = shards_on(cards, x, LAYOUTS[k], CARDS[k])
    P.clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                check(L.flagstat_sharded(shards, impl="cuda"), x)
        spans = P.spans()
    finally:
        P.clear_spans()
    names = [s.name for s in spans]
    assert sorted(set(names)) == ["lfs.flagstat_sharded", "lfs.launch", "lfs.readback",
                                  "lfs.shard.merge"]
    assert all(names.count(n) == 2 for n in set(names))
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "lfs.flagstat_sharded":
            assert s.parent is None
            assert s.args == {"shards": k, "words": x.size, "impl": "cuda"}
            continue
        p = by_id[s.parent]
        assert p.name == "lfs.flagstat_sharded"
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        if s.name == "lfs.launch":
            assert s.args == {"mode": "flagstat", "words": x.size}
        if s.name == "lfs.shard.merge":
            assert s.args == {"peers": k - 1}
    for call in [s for s in spans if s.name == "lfs.flagstat_sharded"]:
        inside = [s.name for s in spans if s.parent == call.id]
        assert inside == ["lfs.launch", "lfs.shard.merge", "lfs.readback"]


def test_a_native_error_raises_naming_the_entry(cards, monkeypatch):
    x = column(2, seed=6)
    shards = shards_on(cards, x, LAYOUTS[2], CARDS[2])
    monkeypatch.setattr(cards, "counts", lambda *a: 700)
    monkeypatch.setattr(cuda_build, "load", lambda: SimpleNamespace(
        lfs_sharded_counts=cards.counts, lfs_sharded_merge=cards.merge))
    with pytest.raises(RuntimeError, match=r"lfs_sharded_counts \(flagstat\) failed: "
                                           "cudaError 700"):
        L.flagstat_sharded(shards, impl="cuda")
    monkeypatch.setattr(cuda_build, "load", lambda: SimpleNamespace(
        lfs_sharded_counts=FakeCards().counts, lfs_sharded_merge=lambda *a: 1))
    with pytest.raises(RuntimeError, match=r"lfs_sharded_merge \(epilogue\) failed"):
        L.flagstat_sharded(shards, impl="cuda")


# ---- on the cards ----

@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards: run on them with python3 -m pytest "
                    "tests/test_torch_sharded_one_call.py -m card --noconftest")
    return [torch.device("cuda", i) for i in range(min(4, torch.cuda.device_count()))]


@pytest.mark.card
@pytest.mark.parametrize("report", [False, True])
def test_card_native_counts_equal_the_oracle_and_the_general_path(two_cards, report,
                                                                  monkeypatch):
    for k in range(2, len(two_cards) + 1):
        for lengths in ([1 << 20] * k, [0] + [777_777 + i for i in range(k - 1)],
                        [5, 0] + [3 * (1 << 20) + 3] * (k - 2)):
            x = generate_flags(sum(lengths), seed=k + sum(lengths), full_range=True)
            cuts = np.cumsum([0] + lengths)
            devs = two_cards[:k][::-1]       # the first shard on the last card
            shards = [torch.from_numpy(x[a:b].view(np.int16)).to(d)
                      for a, b, d in zip(cuts[:-1], cuts[1:], devs)]
            caller = torch.cuda.current_device()
            got, (one, sharded, launches) = counted(
                lambda: L.flagstat_sharded(shards, report=report))
            assert torch.cuda.current_device() == caller
            check(got, x, report)
            mode = "flagstat_report" if report else "flagstat"
            assert one == {"calls": 1}, (k, lengths)
            assert sharded == {"calls": 1, "shards": k, "peer_copies": k - 1}
            assert launches[mode] == sum(n > 0 for n in lengths)
            assert launches["epilogue"] == 1
            with monkeypatch.context() as m:
                m.setattr(S, "_native_cards", lambda shards, impl: None)
                general, (one, _, _) = counted(
                    lambda: L.flagstat_sharded(shards, report=report))
            assert one == {"calls": 0}
            np.testing.assert_array_equal(got, general)


@pytest.mark.card
def test_card_native_count_keeps_the_callers_device_and_repeats(two_cards):
    x = generate_flags(2_000_003, seed=91, full_range=True)
    cuts = [0, 1_000_000, x.size]
    shards = [torch.from_numpy(x[a:b].view(np.int16)).to(d)
              for a, b, d in zip(cuts[:-1], cuts[1:], two_cards[:2])]
    for caller in (two_cards[1], two_cards[0]):
        torch.cuda.set_device(caller)
        for _ in range(5):
            check(L.flagstat_sharded(shards), x)
            assert torch.cuda.current_device() == caller.index

"""The one-call count of ``flagstats_u16`` (``ops/dispatch._one_call``,
``kernels.flagstat_count``, ``staging.count_piece``).

On the CPU the native entry ``lfs_flagstat_count`` is replaced by a fake
that records its arguments and does its work on the CPU memory behind
them: the copy of a host slot into its twin, K1's sums by the plain
version, the epilogue by its plain twin into ``out`` and the pinned
buffer. A "card tensor" there is a CPU tensor registered with the fake
card. The tests check where the path engages (one piece on a card) and
where it does not (one word past each limit, the other impls, the CPU),
the counters against ``flagstat_numpy``, the counts of ``ONE_CALL``,
``LAUNCHES`` and ``STAGED``, ``out=`` accumulation, the ring's hazards,
and the spans the benchmark's readers read.

The tests marked ``card`` run on a CUDA card and skip without one
(``python3 -m pytest tests/test_torch_one_call.py -m card --noconftest``;
this file imports no JAX)."""
import ctypes
import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.bench import profiling as P
from libflagstats_tpu_torch.ops import cuda_build
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import staging as ST
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags

PIECE = 4096          # STAGE_WORDS in the fake world
CAP = 5000            # DEVICE_WORD_CAP in the fake world
STREAM = 0x5EED       # the raw stream handle the fake world hands out
DONE = 0xD0E          # every fake scratch's event handle
REPORT_ZEROS = [1, 3, 4, 5, 17, 19, 20, 21]


def check(got, x: np.ndarray, impl: str = "cuda") -> None:
    got, want = np.asarray(got, np.int64), flagstat_numpy(x).astype(np.int64)
    if impl == "cuda_report":
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


class Event:
    """A fake card event: counts its waits."""

    def __init__(self, handle: int = DONE):
        self.cuda_event = handle
        self.waits = 0

    def synchronize(self) -> None:
        self.waits += 1


class Scratch:
    """A thread's fake ``kernels._Scratch``, in CPU memory."""

    def __init__(self):
        self.acc = torch.empty(max(K.RAW_STREAMS.values()), dtype=torch.int64)
        self.out = torch.empty(F.N_COUNTERS, dtype=torch.int64)
        self.host = torch.empty(F.N_COUNTERS, dtype=torch.int64)
        self.host_np = self.host.numpy()
        self.done = Event()
        self.ptrs = (self.acc.data_ptr(), self.out.data_ptr(), self.host.data_ptr(), DONE)


class FakeCard:
    """The fake world's card: its tensors, scratch, rings and native
    entry, which records each call's arguments."""

    def __init__(self):
        self.storages: set[int] = set()
        self.calls: list[dict] = []
        self.scratches: dict = {}
        self.rings: dict = {}

    def tensor(self, x: np.ndarray) -> torch.Tensor:
        """A "card tensor" of the words ``x``."""
        t = torch.from_numpy(np.ascontiguousarray(x).view(np.int16)).clone()
        self.storages.add(t.untyped_storage().data_ptr())
        return t

    def held(self, words):
        """Card 0 for a "card tensor", else None."""
        if (isinstance(words, torch.Tensor)
                and words.untyped_storage().data_ptr() in self.storages):
            return torch.device("cuda", 0)
        return None

    def scratch(self, dev) -> Scratch:
        key = (threading.get_ident(), dev)
        if key not in self.scratches:
            self.scratches[key] = Scratch()
        return self.scratches[key]

    def ring(self, dev) -> ST._Ring:
        """A CPU ring whose device twins are memory of their own, so a
        count that skipped the copy into the twin reads the wrong words."""
        key = (torch.device(dev), ST.STAGE_WORDS)
        if key not in self.rings:
            r = ST._Ring((max(ST.STAGE_WORDS, K.GROUP_WORDS),), torch.int16,
                         torch.device("cpu"), ST.DEPTH)
            r.dev = [torch.full_like(h, -1) for h in r.host]
            self.rings[key] = r
        return self.rings[key]

    def entry(self, device, mode, src, n, words, acc, out, emap, host, consumed, done, stream):
        kind = K.MODES[mode]
        self.calls.append(dict(device=device, mode=kind, src=src, n=n, words=words, acc=acc,
                               out=out, host=host, consumed=consumed, done=done, stream=stream))
        assert (tuple(emap.c), tuple(emap.c2), tuple(emap.f)) == K.epilogue_map(kind)
        assert emap.qc == F.FQCFAIL_OFF
        if src and n:
            ctypes.memmove(words, src, 2 * n)
        sums = at(acc, K.RAW_STREAMS[kind], torch.int64)
        sums.zero_()                                   # the memset
        sums += K.stream_sums_plain(at(words, n, torch.int16), kind)   # K1 adds
        counters = K.epilogue_plain(sums, kind, n)
        at(out, F.N_COUNTERS, torch.int64).copy_(counters)
        at(host, F.N_COUNTERS, torch.int64).copy_(counters)
        return 0


@pytest.fixture
def card(monkeypatch):
    """The fake world: a card that is present, current device 0; the
    native entry, the scratch, the rings and the raw stream faked; the
    general path's card tallies ending through the plain epilogue;
    STAGE_WORDS = PIECE."""
    fake = FakeCard()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(D, "_held", fake.held)
    monkeypatch.setattr(K, "scratch", fake.scratch)
    monkeypatch.setattr(K, "raw_stream", lambda dev: STREAM)
    monkeypatch.setattr(ST, "ring", fake.ring)
    monkeypatch.setattr(cuda_build, "load", lambda: SimpleNamespace(lfs_flagstat_count=fake.entry))
    monkeypatch.setattr(K, "counters_cuda",
                        lambda acc, kind, n, timer=None:
                        K.epilogue_plain(acc, kind, n).numpy().astype(np.uint64))
    monkeypatch.setattr(K, "epilogue_cuda",
                        lambda acc, kind, n=None, out=None, host=None, done=None:
                        K.epilogue_plain(acc, kind, n))
    monkeypatch.setattr(ST, "STAGE_WORDS", PIECE)
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", CAP)
    return fake


def counted(fn):
    """(fn's result, what it added to ONE_CALL, LAUNCHES and STAGED)."""
    before = (dict(D.ONE_CALL), dict(K.LAUNCHES), dict(ST.STAGED))
    got = fn()
    after = (D.ONE_CALL, K.LAUNCHES, ST.STAGED)
    return got, [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]


@pytest.mark.parametrize("impl", ["cuda", "cuda_report"])
@pytest.mark.parametrize("n", [0, 1, 7, CAP])
def test_a_card_tensor_within_the_cap_is_one_call(card, impl, n):
    x = generate_flags(n, seed=n + 3, full_range=True)
    t = card.tensor(x)
    got, (one, launches, staged) = counted(lambda: L.flagstats_u16(t, impl=impl))
    check(got, x, impl)
    assert got.dtype == np.uint64 and got.shape == (32,)
    mode = "flagstat_report" if impl == "cuda_report" else "flagstat"
    (call,) = card.calls
    assert call == dict(device=0, mode=mode, src=None, n=n, words=t.data_ptr(),
                        acc=call["acc"], out=call["out"], host=call["host"], consumed=None,
                        done=DONE, stream=STREAM)
    s = card.scratch(torch.device("cuda", 0))
    assert (call["acc"], call["out"], call["host"]) == s.ptrs[:3] and s.done.waits == 1
    assert one == {"calls": 1} and staged == {"columns": 0, "pieces": 0, "direct": 0}
    assert {k: v for k, v in launches.items() if v} == (
        {mode: 1, "epilogue": 1} if n else {"epilogue": 1})


@pytest.mark.parametrize("impl", [None, "cuda", "cuda_report"])
@pytest.mark.parametrize("form", ["numpy", "cpu tensor"])
@pytest.mark.parametrize("n", [0, 1, 7, PIECE])
def test_a_host_column_within_a_piece_is_one_call_through_a_ring_slot(card, impl, form, n):
    x = generate_flags(n, seed=n + 5, full_range=True)
    col = x if form == "numpy" else torch.from_numpy(x.view(np.int16))
    r = card.ring(torch.device("cuda", 0))
    slot = r.next
    got, (one, launches, staged) = counted(lambda: L.flagstats_u16(col, impl=impl))
    check(got, x, impl or "cuda")
    mode = "flagstat_report" if impl == "cuda_report" else "flagstat"
    (call,) = card.calls
    assert call["device"] == 0 and call["mode"] == mode and call["n"] == n
    assert call["words"] == r.dev[slot].data_ptr()
    assert call["src"] == r.host[slot].data_ptr()
    assert call["consumed"] is None and call["stream"] == STREAM
    assert r.next == (slot + 1) % ST.DEPTH
    assert r.copied[slot] is None and r.consumed[slot] is None
    assert one == {"calls": 1}
    assert staged == {"columns": 1, "pieces": int(n > 0), "direct": 0}
    assert {k: v for k, v in launches.items() if v} == (
        {mode: 1, "epilogue": 1} if n else {"epilogue": 1})


@pytest.mark.parametrize("case", ["card tensor, cap + 1", "host column, piece + 1",
                                  "host column within a piece, past the cap"])
def test_one_word_past_each_limit_takes_the_general_path(card, monkeypatch, case):
    if case.startswith("host column within"):
        monkeypatch.setattr(D, "DEVICE_WORD_CAP", PIECE - 1)
        n = PIECE
    else:
        n = CAP + 1 if case.startswith("card") else PIECE + 1
    x = generate_flags(n, seed=n, full_range=True)
    col = card.tensor(x) if case.startswith("card") else x
    got, (one, _, _) = counted(lambda: L.flagstats_u16(col, impl="cuda"))
    check(got, x)
    assert card.calls == [] and one == {"calls": 0}


@pytest.mark.parametrize("impl,device", [("cuda_pre", None), ("cuda_words", None),
                                         ("torch", None), ("numpy", None), ("native", None),
                                         (None, "cpu"), ("cuda", "cpu"),
                                         ("cuda_report", "cpu")])
@pytest.mark.parametrize("held", ["card", "host"])
def test_other_impls_and_the_cpu_take_the_general_path(card, impl, device, held):
    x = generate_flags(PIECE // 2, seed=9, full_range=True)
    col = card.tensor(x) if held == "card" else x
    got, (one, _, _) = counted(lambda: L.flagstats_u16(col, impl=impl, device=device))
    check(got, x, impl or "cuda")
    assert card.calls == [] and one == {"calls": 0}


@pytest.mark.parametrize("device", ["cuda:0", "cuda", torch.device("cuda", 0)])
def test_a_card_tensor_on_the_card_named_is_one_call(card, device):
    x = generate_flags(64, seed=2, full_range=True)
    got, (one, _, _) = counted(lambda: L.flagstats_u16(card.tensor(x), device=device))
    check(got, x)
    assert len(card.calls) == 1 and one == {"calls": 1}


def test_a_card_tensor_named_on_another_card_takes_the_general_path(card):
    x = generate_flags(64, seed=2, full_range=True)
    t = card.tensor(x)          # lies on card 0; the call names card 1
    got, (one, _, _) = counted(lambda: L.flagstats_u16(t, impl="cuda", device="cuda:1"))
    check(got, x)
    assert card.calls == [] and one == {"calls": 0}


def test_out_accumulates_across_calls(card):
    x = generate_flags(7 * PIECE + 3, seed=17, full_range=True)
    out = np.zeros(32, dtype=np.uint64)
    bounds = list(range(0, x.size, PIECE)) + [x.size]
    for i, (a, b) in enumerate(zip(bounds, bounds[1:])):
        block = card.tensor(x[a:b]) if i % 2 else x[a:b]
        assert L.flagstats_u16(block, out=out) is out
    check(out, x)
    assert len(card.calls) == len(bounds) - 1
    assert [c["src"] is None for c in card.calls] == [bool(i % 2) for i in range(len(bounds) - 1)]


def test_an_odd_offset_slice_of_a_card_tensor(card):
    x = generate_flags(3001, seed=4, full_range=True)
    t = card.tensor(x)
    got = L.flagstats_u16(t[1:2999], impl="cuda")
    check(got, x[1:2999])
    assert card.calls[0]["words"] == t.data_ptr() + 2


def test_a_slot_is_taken_after_its_last_copy_and_shipped_behind_its_last_reader(card):
    r = card.ring(torch.device("cuda", 0))
    slot = r.next
    copied, consumed = Event(1), Event(2)
    r.copied[slot], r.consumed[slot] = copied, consumed
    x = generate_flags(100, seed=6, full_range=True)
    check(L.flagstats_u16(x), x)
    assert copied.waits == 1 and card.calls[0]["consumed"] == 2
    assert r.copied[slot] is None and r.consumed[slot] is None


def test_the_ring_is_shared_with_the_general_path(card):
    """A staged count after one-call counts takes its slots where they
    left the ring, and both count right."""
    a = generate_flags(PIECE, seed=1, full_range=True)
    b = generate_flags(3 * PIECE + 1, seed=2, full_range=True)
    for _ in range(3):
        check(L.flagstats_u16(a), a)
        check(L.flagstats_u16(b), b)
    assert len(card.calls) == 3


def test_the_stream_sharded_and_pospopcnt_counts_take_no_one_call(card, tmp_path):
    from libflagstats_tpu_torch.io import codec as C

    x = generate_flags(20_001, seed=8, full_range=True)
    path = tmp_path / "x.lz4"
    C.write_framed(path, x, codec="lz4", level=1, block_bytes=8_000)
    _, (one, _, _) = counted(lambda: (
        check(L.flagstat_stream(path, "lz4", impl="cuda", device="cpu"), x),
        check(L.flagstat_sharded(x, devices=["cpu"] * 2), x),
        L.pospopcnt_u16(x, impl="numpy")))
    assert card.calls == [] and one == {"calls": 0}


@pytest.mark.parametrize("held", ["card", "host"])
def test_spans_are_those_the_benchmark_reads(card, held, tmp_path):
    from cardbench.layer_metrics import dispatch_self_us_p50, host_copy_gbps, launch_us_p50
    from cardbench.yardstick import TraceView

    P.clear_spans()
    x = generate_flags(PIECE, seed=12, full_range=True)
    col = card.tensor(x) if held == "card" else x
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("cardbench.window"):
            for _ in range(3):
                check(L.flagstats_u16(col), x)
    spans = P.spans()
    names = [s.name for s in spans]
    assert names.count("lfs.flagstats_u16") == names.count("lfs.launch") \
        == names.count("lfs.readback") == 3
    assert names.count("lfs.stage.copy_in") == names.count("lfs.stage.acquire") \
        == (3 if held == "host" else 0)
    assert not {"lfs.assemble", "lfs.stage.ship"} & set(names)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "lfs.flagstats_u16":
            assert s.args == {"words": PIECE, "impl": "cuda", "held": held}
            assert s.parent is None
        else:
            p = by_id[s.parent]
            assert p.name == "lfs.flagstats_u16"
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        if s.name == "lfs.launch":
            assert s.args == {"mode": "flagstat", "words": PIECE}
        if s.name == "lfs.stage.copy_in":
            assert s.args == {"bytes": 2 * PIECE}
        if s.name == "lfs.stage.acquire":
            assert set(s.args) == {"slot"}
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        events = json.load(f)["traceEvents"]
    try:
        view = TraceView(events, reports=3, words=3 * PIECE, kind="cpu")
        assert view.hi > view.lo
        assert launch_us_p50.read(view) > 0
        assert dispatch_self_us_p50.read(view) > 0
        copy = host_copy_gbps.read(view)
        assert (copy is not None and copy > 0) if held == "host" else copy is None
    finally:
        P.clear_spans()


def test_threads_count_at_once(card):
    """More threads than cores, each counting its own blocks, card and
    host, with a short switch interval: every thread's accumulator is its
    oracle's (a slot or a scratch shared without the lock would mix
    them)."""
    xs = [generate_flags(5 * PIECE, seed=40 + i, full_range=True) for i in range(12)]
    outs = [np.zeros(32, dtype=np.uint64) for _ in xs]
    errors = []

    def work(i):
        try:
            for a in range(0, xs[i].size, PIECE):
                block = xs[i][a:a + PIECE]
                L.flagstats_u16(card.tensor(block) if (a // PIECE + i) % 2 else block,
                                out=outs[i])
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    for x, out in zip(xs, outs):
        check(out, x)
    assert len(card.calls) == 5 * len(xs)


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with python3 -m pytest "
                    "tests/test_torch_one_call.py -m card --noconftest")
    return torch.device("cuda", torch.cuda.current_device())


def one_call_counted(fn):
    """fn's result, after asserting that it took the one-call path with
    one K1 (or K3) and one epilogue."""
    got, (one, launches, _) = counted(fn)
    assert one == {"calls": 1}, one
    return got, launches


@pytest.mark.card
@pytest.mark.parametrize("impl", ["cuda", "cuda_report"])
def test_card_counts_equal_the_oracle(cuda, impl):
    mode = "flagstat_report" if impl == "cuda_report" else "flagstat"
    for n in (0, 1, 7, 8, 512_000, ST.STAGE_WORDS, ST.STAGE_WORDS + 1):
        x = generate_flags(n, seed=n + 101, full_range=True)
        xd = torch.from_numpy(x.view(np.int16)).to(cuda)
        got, launches = one_call_counted(lambda: L.flagstats_u16(xd, impl=impl))
        check(got, x, impl)
        assert launches[mode] == int(n > 0) and launches["epilogue"] == 1, (n, launches)
        got, (one, launches, staged) = counted(lambda: L.flagstats_u16(x, impl=impl))
        check(got, x, impl)
        if n <= ST.STAGE_WORDS:
            assert one == {"calls": 1}
            assert staged == {"columns": 1, "pieces": int(n > 0), "direct": 0}
            assert launches[mode] == int(n > 0) and launches["epilogue"] == 1, (n, launches)
        else:
            assert one == {"calls": 0} and staged == {"columns": 1, "pieces": 2, "direct": 0}
    x = generate_flags(1 << 20, seed=7, full_range=True)
    xd = torch.from_numpy(x.view(np.int16)).to(cuda)
    for a, b in ((1, 1 << 20), (3, 777_777), (5, 6)):
        got, _ = one_call_counted(lambda: L.flagstats_u16(xd[a:b], impl=impl))
        check(got, x[a:b], impl)


@pytest.mark.card
@pytest.mark.parametrize("held", ["card", "host"])
def test_card_out_accumulates_over_1611_blocks(cuda, held):
    block = 65_536
    x = np.random.default_rng(1611).integers(0, 1 << 16, 1611 * block - 5, dtype=np.uint16)
    col = torch.from_numpy(x.view(np.int16)).to(cuda) if held == "card" else x
    out = np.zeros(32, dtype=np.uint64)
    before = (D.ONE_CALL["calls"], K.LAUNCHES["flagstat"], K.LAUNCHES["epilogue"])
    for a in range(0, x.size, block):
        assert L.flagstats_u16(col[a:a + block], out=out) is out
    check(out, x)
    after = (D.ONE_CALL["calls"], K.LAUNCHES["flagstat"], K.LAUNCHES["epilogue"])
    assert [b - a for a, b in zip(before, after)] == [1611, 1611, 1611]


@pytest.mark.card
def test_card_two_threads_count_at_once(cuda):
    block = 512_000
    xs = [np.random.default_rng(s).integers(0, 1 << 16, 64 * block + 11, dtype=np.uint16)
          for s in (1, 2)]
    cols = [torch.from_numpy(xs[0].view(np.int16)).to(cuda), xs[1]]
    outs = [np.zeros(32, dtype=np.uint64) for _ in cols]
    errors = []

    def work(i):
        try:
            torch.cuda.set_device(cuda)
            for _ in range(3):
                acc = np.zeros(32, dtype=np.uint64)
                for a in range(0, xs[i].size, block):
                    L.flagstats_u16(cols[i][a:a + block], out=acc)
                check(acc, xs[i])
                outs[i] += acc
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and errors == []
    for x, out in zip(xs, outs):
        np.testing.assert_array_equal(out, 3 * flagstat_numpy(x))


#: every kernel the grid cache holds: (LAUNCHES key, variant)
WAVE_KERNELS = ([(m, 0) for m in K.MODES] + [("pre", 32), ("pre", 24), ("pre_report", 32),
                                              ("pre_report", 20), ("words", 0)]
                + [(p, 0) for p in K.PROBES + ("fold_xor",)] + [("setop", op) for op in range(4)])


def launch_grids(fn, dev, tmp_path) -> dict:
    """{kernel name: [grid x of each launch]} of what ``fn`` enqueues on
    ``dev``, from a profiler trace."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    path = tmp_path / f"grids_{dev.index}.json"
    prof.export_chrome_trace(str(path))
    grids: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            grids.setdefault(e["name"], []).append(e["args"]["grid"][0])
    return grids


@pytest.mark.card
def test_card_cached_grid_is_the_queried_wave(cuda, tmp_path):
    """On every card present: every kernel's wave is SMs times its
    resident blocks and reads the same each time; the launchers read
    that cache, so K1 through its launcher and through the one-call
    entry, K3 and K6 over more than a wave launch one wave of blocks."""
    from libflagstats_tpu_torch.ops import words_kernels as W

    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        waves = {}
        for key, variant in WAVE_KERNELS:
            wave = waves[key, variant] = K.wave_blocks(key, dev, variant)
            assert wave > 0 and wave % sms == 0, (dev, key, variant, wave)
            assert K.wave_blocks(key, dev, variant) == wave
        with pytest.raises(RuntimeError, match="lfs_wave_blocks"):
            K.wave_blocks("no such kernel", dev)
        x = torch.zeros(2 * max(K.wave_words(m, dev) for m in K.MODES + ("words",)) + 1,
                        dtype=torch.int16, device=dev)
        with torch.cuda.device(dev):
            grids = launch_grids(lambda: (K.stream_sums_cuda(x, "flagstat"),
                                          K.stream_sums_cuda(x, "flagstat_report"),
                                          W.stream_sums_words_cuda(x),
                                          L.flagstats_u16(x)), dev, tmp_path)
        k1 = [g for name, gs in grids.items() if "stream_sums_kernel" in name for g in gs]
        k6 = [g for name, gs in grids.items() if "stream_sums_words_kernel" in name for g in gs]
        assert sorted(k1) == sorted([waves["flagstat", 0]] * 2 + [waves["flagstat_report", 0]]), \
            grids
        assert k6 == [waves["words", 0]], grids

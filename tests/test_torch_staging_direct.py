"""ops/staging.py: a host column the caller holds in page-locked memory
ships its pieces straight from the caller's memory (``ships_direct``).

The CPU has no page-locked memory, so these tests mark the columns they
call pinned (``torch.Tensor.is_pinned`` answers yes for their storage
alone) and let the rule take the CPU for a card; everything else runs as
it does on the CPU, each piece counted in place by the kernels' plain
versions. Every count is held against the JAX package's on the same
seeded input and the oracle. The rule itself is checked as it is, the
one-call path through a spy on ``kernels.flagstat_count``, and the wait
on the last copy from the caller's memory through fake copy events."""
import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libflagstats_tpu as J

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.bench import profiling as P
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import staging as ST
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags

PIECE = 4096
SIZES = {"0": 0, "1": 1, "piece-1": PIECE - 1, "piece": PIECE, "piece+1": PIECE + 1,
         "3piece+5": 3 * PIECE + 5}
REPORT_ZEROS = [1, 3, 4, 5, 17, 19, 20, 21]
CARD = torch.device("cuda", 0)


@pytest.fixture
def pinned(monkeypatch):
    """Mark a tensor's storage pinned: ``pinned(t)`` returns ``t``. The
    rule takes the CPU for a card; STAGE_WORDS = PIECE."""
    marked = set()
    monkeypatch.setattr(torch.Tensor, "is_pinned",
                        lambda self: self.untyped_storage().data_ptr() in marked)
    real = ST.ships_direct
    monkeypatch.setattr(ST, "ships_direct", lambda words, impl, device: real(words, impl, CARD))
    monkeypatch.setattr(ST, "STAGE_WORDS", PIECE)
    P.clear_spans()
    yield lambda t: marked.add(t.untyped_storage().data_ptr()) or t
    P.clear_spans()


def column(n: int, seed: int) -> tuple[np.ndarray, torch.Tensor]:
    """``n`` seeded full-range words, as numpy and as an int16 tensor of
    its own memory."""
    x = generate_flags(n, seed=seed, full_range=True)
    return x, torch.from_numpy(x.view(np.int16).copy())


def traced(fn):
    """(fn's result, the spans it recorded, what it added to STAGED)."""
    before = dict(ST.STAGED)
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, P.spans(), {k: ST.STAGED[k] - before[k] for k in before}


def named(spans, name):
    return [s for s in spans if s.name == name]


def check(got, want, impl: str) -> None:
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    if impl == "cuda_report":
        idx = list(F.REPORT_COUNTERS)
        np.testing.assert_array_equal(got[idx], want[idx])
        assert not got[REPORT_ZEROS].any()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["cuda", "cuda_report", "cuda_words", "pospopcnt"])
@pytest.mark.parametrize("size", list(SIZES))
def test_a_pinned_column_ships_every_piece_from_the_callers_memory(pinned, impl, size):
    n = SIZES[size]
    x, t = column(n, seed=n + 61)
    pinned(t)
    if impl == "pospopcnt":
        got, spans, staged = traced(lambda: L.pospopcnt_u16(t, impl="cuda", device="cpu"))
        np.testing.assert_array_equal(got, J.pospopcnt_u16(x, impl="numpy"))
        np.testing.assert_array_equal(got, J.pospopcnt_u16(x, impl="xla"))
    else:
        got, spans, staged = traced(lambda: L.flagstats_u16(t, impl=impl, device="cpu"))
        check(got, J.flagstats_u16(x, impl="numpy"), impl)
        check(got, J.flagstats_u16(x, impl="xla"), impl)
        check(got, flagstat_numpy(x), impl)
    pieces = -(-n // PIECE)
    assert staged == {"columns": 1, "pieces": pieces, "direct": pieces}
    assert not named(spans, "lfs.stage.copy_in")
    ships = named(spans, "lfs.stage.ship")
    assert len(ships) == pieces and all(s.args["source"] == "caller" for s in ships)
    assert sum(s.args["bytes"] for s in ships) == 2 * n


@pytest.mark.parametrize("impl,source", [("cuda_pre", "pinned"), ("cuda", "pageable tensor"),
                                         ("cuda", "numpy"), ("cuda_words", "pageable tensor"),
                                         ("pospopcnt", "pageable tensor")])
def test_cuda_pre_and_a_pageable_column_still_go_through_the_slots(pinned, impl, source):
    step = K.GROUP_WORDS if impl == "cuda_pre" else PIECE
    n = 2 * step + 7
    x, t = column(n, seed=67)
    col = x if source == "numpy" else pinned(t) if source == "pinned" else t
    if impl == "pospopcnt":
        got, spans, staged = traced(lambda: L.pospopcnt_u16(col, impl="cuda", device="cpu"))
        np.testing.assert_array_equal(got, J.pospopcnt_u16(x, impl="numpy"))
    else:
        got, spans, staged = traced(lambda: L.flagstats_u16(col, impl=impl, device="cpu"))
        check(got, J.flagstats_u16(x, impl="numpy"), impl)
    assert staged == {"columns": 1, "pieces": 3, "direct": 0}
    ships = named(spans, "lfs.stage.ship")
    assert len(ships) == 3 and all(s.args["source"] == "slot" for s in ships)
    moved = named(spans, "lfs.stage.transpose" if impl == "cuda_pre" else "lfs.stage.copy_in")
    assert len(moved) == 3


@pytest.mark.parametrize("device,impl,pin,contiguous,want", [
    (CARD, "cuda", True, True, True),
    (CARD, "cuda_words", True, True, True),
    (CARD, "pospopcnt", True, True, True),
    (torch.device("cpu"), "cuda", True, True, False),
    (CARD, "cuda_pre", True, True, False),
    (CARD, "torch", True, True, False),
    (CARD, "cuda", False, True, False),
    (CARD, "cuda", True, False, False),
])
def test_the_rule_reads_the_source_the_impl_and_the_device(monkeypatch, device, impl, pin,
                                                          contiguous, want):
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: pin)
    words = torch.zeros(64, dtype=torch.int16)
    assert ST.ships_direct(words if contiguous else words[::2], impl, device) is want


class _Ring(ST._Ring):
    """A CPU ring whose device twins are memory of their own."""

    def __init__(self):
        super().__init__((ST.STAGE_WORDS,), torch.int16, torch.device("cpu"), ST.DEPTH)
        self.dev = [torch.full_like(h, -1) for h in self.host]


@pytest.mark.parametrize("mode", ["flagstat", "flagstat_report"])
@pytest.mark.parametrize("n", [1, PIECE - 1, PIECE])
@pytest.mark.parametrize("pin", [True, False])
def test_a_one_piece_pinned_column_reaches_the_native_call_at_its_own_address(
        pinned, monkeypatch, mode, n, pin):
    """The one-call path: the native call copies from the column's own
    address (a pinned column) or from the slot the column was copied
    into (a pageable one)."""
    ring = _Ring()
    calls = []

    def flagstat_count(dev, kind, words, n_words, src, consumed=None):
        calls.append(dict(dev=dev, mode=kind, words=words, n=n_words, src=src))
        got = np.frombuffer((ctypes.c_uint16 * n_words).from_address(src), np.uint16)
        return flagstat_numpy(got)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ST, "ring", lambda dev: ring)
    monkeypatch.setattr(K, "flagstat_count", flagstat_count)
    x, t = column(n, seed=n + 71)
    if pin:
        pinned(t)
    impl = "cuda_report" if mode == "flagstat_report" else "cuda"
    got, spans, staged = traced(lambda: L.flagstats_u16(t, impl=impl, device="cuda:0"))
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    (call,) = calls
    slot = (ring.next - 1) % ST.DEPTH
    assert call == dict(dev=CARD, mode=mode, words=ring.dev[slot].data_ptr(), n=n,
                        src=t.data_ptr() if pin else ring.host[slot].data_ptr())
    assert staged == {"columns": 1, "pieces": 1, "direct": int(pin)}
    assert len(named(spans, "lfs.stage.copy_in")) == int(not pin)


class _Event:
    """A fake copy event: logs each wait."""

    def __init__(self, log, k):
        self.log, self.k = log, k

    def synchronize(self):
        self.log.append(("wait", self.k))


def test_stage_returns_after_the_last_copy_from_the_callers_memory(pinned, monkeypatch):
    """Each direct ship leaves an event in ``copied[slot]``; ``stage``
    waits on the last one once, after the last piece's count was
    enqueued, and the slots' refills wait on theirs as before."""
    log = []

    class Ring(_Ring):
        def ship(self, slot, n, timer=None, into=None, src=None):
            out = super().ship(slot, n, timer, into, src)
            self.copied[slot] = _Event(log, len([e for e in log if e[0] == "ship"]))
            log.append(("ship", slot))
            return out

    ring = Ring()
    monkeypatch.setattr(ST, "ring", lambda dev: ring)
    add = ST.Tally.add
    monkeypatch.setattr(ST.Tally, "add",
                        lambda self, piece: log.append(("add",)) or add(self, piece))
    n = (ST.DEPTH + 2) * PIECE + 3
    x, t = column(n, seed=73)
    pinned(t)
    np.testing.assert_array_equal(L.flagstats_u16(t, impl="cuda", device="cpu"),
                                  flagstat_numpy(x))
    pieces = -(-n // PIECE)
    assert [e[0] for e in log].count("ship") == pieces
    # the refill of a slot waits on the copy that last read it; then one
    # wait on the last copy, after the last count
    waits = [e[1] for e in log if e[0] == "wait"]
    assert waits == list(range(pieces - ST.DEPTH)) + [pieces - 1]
    assert log[-2:] == [("add",), ("wait", pieces - 1)]

"""ops/staging.py on the CPU: a host column counted through the staging
ring in pieces of a shrunk STAGE_WORDS, with device="cpu", where each
piece is counted in place by the kernels' plain versions. Every count is
held against the JAX package's on the same seeded input (impl "numpy",
"xla", its flagstat_sharded and flagstat_multihost) and the oracle:
all 32 counters, REPORT_COUNTERS in report mode, the 16 positional
counts. Exact (tolerance 0)."""
import jax
import numpy as np
import pytest
import torch

import libflagstats_tpu as J
from libflagstats_tpu.ops import dispatch as jD
from libflagstats_tpu.parallel import multihost as jM
from libflagstats_tpu.parallel import sharded as jS

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import staging as ST
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.parallel import multihost as M
from libflagstats_tpu_torch.parallel import sharded as S

#: STAGE_WORDS in these tests: a raw-word piece; a cuda_pre piece is then
#: one transpose group (K.GROUP_WORDS words)
PIECE = 4096
IMPLS = ("cuda", "cuda_report", "cuda_words", "cuda_pre")
REPORT_ZEROS = [1, 3, 4, 5, 17, 19, 20, 21]


@pytest.fixture
def piece(monkeypatch):
    monkeypatch.setattr(ST, "STAGE_WORDS", PIECE)


def _step(impl: str) -> int:
    return K.GROUP_WORDS if impl == "cuda_pre" else PIECE


def _check(got, want, impl: str) -> None:
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    if impl == "cuda_report":
        idx = list(F.REPORT_COUNTERS)
        np.testing.assert_array_equal(got[idx], want[idx])
        assert not got[REPORT_ZEROS].any()
    else:
        np.testing.assert_array_equal(got, want)


def _pieces(fn):
    before = dict(ST.STAGED)
    out = fn()
    return out, ST.STAGED["pieces"] - before["pieces"], ST.STAGED["columns"] - before["columns"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("size", ["0", "1", "piece-1", "piece", "piece+1", "3piece+5"])
def test_one_shot_equals_jax(piece, impl, size):
    """flagstats_u16 on a host column: ceil(n / piece) pieces, the JAX
    package's counters."""
    p = _step(impl)
    n = {"0": 0, "1": 1, "piece-1": p - 1, "piece": p, "piece+1": p + 1,
         "3piece+5": 3 * p + 5}[size]
    x = generate_flags(n, seed=n + 17, full_range=True)
    want = J.flagstats_u16(x, impl="numpy")
    np.testing.assert_array_equal(want, J.flagstats_u16(x, impl="xla"))
    got, pieces, columns = _pieces(lambda: L.flagstats_u16(x, impl=impl, device="cpu"))
    assert got.dtype == np.uint64 and (pieces, columns) == (-(-n // p), 1)
    _check(got, want, impl)
    _check(got, flagstat_numpy(x), impl)


@pytest.mark.parametrize("n", [0, 1, PIECE - 1, PIECE, PIECE + 1, 3 * PIECE + 5])
def test_pospopcnt_equals_jax(piece, n):
    x = generate_flags(n, seed=n + 29, full_range=True)
    got, pieces, _ = _pieces(lambda: L.pospopcnt_u16(x, impl="cuda", device="cpu"))
    assert pieces == -(-n // PIECE)
    np.testing.assert_array_equal(got, J.pospopcnt_u16(x, impl="numpy"))
    np.testing.assert_array_equal(got, J.pospopcnt_u16(x, impl="xla"))


@pytest.mark.parametrize("impl", IMPLS + ("pospopcnt",))
def test_unaligned_view(piece, impl):
    """A view at an odd word offset takes the same path: the slots are
    aligned, the piece is copied into one."""
    n = 2 * _step(impl) + 3
    buf = generate_flags(n + 1, seed=31, full_range=True)
    x = buf[1:]
    assert x.ctypes.data % 4 == 2
    if impl == "pospopcnt":
        np.testing.assert_array_equal(L.pospopcnt_u16(x, impl="cuda", device="cpu"),
                                      J.pospopcnt_u16(x, impl="numpy"))
        return
    _check(L.flagstats_u16(x, impl=impl, device="cpu"), J.flagstats_u16(x, impl="numpy"), impl)
    t = torch.from_numpy(buf.view(np.int16))[1:]
    _check(L.flagstats_u16(t, impl=impl, device="cpu"), J.flagstats_u16(x, impl="numpy"), impl)


@pytest.mark.parametrize("impl", IMPLS)
def test_device_word_cap_derives_counter_9_per_chunk(piece, monkeypatch, impl):
    """A shrunk DEVICE_WORD_CAP: each chunk is staged on its own and its
    counter 9 derived once, with its true length."""
    cap = 70_001 if impl == "cuda_pre" else 5_003
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", cap)
    monkeypatch.setattr(jD, "DEVICE_WORD_CAP", cap)
    x = generate_flags(3 * cap + 77, seed=37, full_range=True)
    chunks = list(D._device_chunks(x))
    assert len(chunks) == 4
    got, pieces, columns = _pieces(lambda: L.flagstats_u16(x, impl=impl, device="cpu"))
    assert columns == len(chunks)
    assert pieces == sum(-(-len(c) // _step(impl)) for c in chunks)
    _check(got, J.flagstats_u16(x, impl="xla"), impl)
    if impl == "cuda":
        pos = L.pospopcnt_u16(x, impl="cuda", device="cpu")
        np.testing.assert_array_equal(pos, J.pospopcnt_u16(x, impl="xla"))


@pytest.mark.parametrize("impl", IMPLS)
def test_out_accumulates(piece, impl):
    x = generate_flags(5 * PIECE + 11, seed=41, full_range=True)
    want = np.zeros(32, np.uint64)
    got = np.zeros(32, np.uint64)
    for block in np.array_split(x, 3):
        J.flagstats_u16(block, out=want, impl="numpy")
        L.flagstats_u16(block, out=got, impl=impl, device="cpu")
    _check(got, want, impl)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 3:
        pytest.skip("needs a virtual CPU mesh")
    return jS.data_mesh()


@pytest.mark.parametrize("impl", S.SHARDED_IMPLS[:3])
@pytest.mark.parametrize("k", [2, 3])
def test_sharded_equals_jax(piece, mesh, impl, k):
    """flagstat_sharded of a host column: every shard's pieces through
    the CPU's one ring, ceil(shard / piece) of them a shard."""
    x = generate_flags(2 * k * _step(impl) + 13, seed=43 + k, full_range=True)
    want = jS.flagstat_sharded(x, mesh=mesh, impl="xla")
    got, pieces, columns = _pieces(lambda: S.flagstat_sharded(x, devices=["cpu"] * k,
                                                              impl=impl))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    bounds = S.shard_bounds(x.size, k, impl)
    assert columns == k and pieces == sum(-(-(b - a) // _step(impl)) for a, b in bounds)
    if impl != "cuda_words":
        rep = S.flagstat_sharded(x, devices=["cpu"] * k, impl=impl, report=True)
        _check(rep, want, "cuda_report")


@pytest.mark.parametrize("impl", S.SHARDED_IMPLS[:3])
def test_multihost_one_process_equals_jax(piece, monkeypatch, mesh, impl):
    """flagstat_multihost outside a process group: the rank's column
    goes through the ring as sharded_sums' one shard."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    x = generate_flags(3 * _step(impl) + 5, seed=47, full_range=True)
    want = jM.flagstat_multihost(x, impl="xla")
    got, pieces, _ = _pieces(lambda: M.flagstat_multihost(x, impl=impl, device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert pieces == 4


@pytest.mark.parametrize("impl", IMPLS + ("pospopcnt",))
def test_no_column_reaches_the_count_whole(piece, monkeypatch, impl):
    """Spies on the ring and the kernel wrappers: each piece is acquired,
    shipped and released in that order, slot after slot round the ring,
    and the count sees pieces of at most a piece's words, never the
    column."""
    calls, seen = [], []

    class Spy(ST._Ring):
        def acquire(self):
            slot = super().acquire()
            calls.append(("acquire", slot))
            return slot

        def ship(self, slot, n):
            calls.append(("ship", slot))
            return super().ship(slot, n)

        def release(self, slot):
            calls.append(("release", slot))
            super().release(slot)

    monkeypatch.setattr(ST, "_Ring", Spy)
    monkeypatch.setattr(ST, "_RINGS", {})
    real = {"cuda": K.stream_sums_cuda, "pre": K.stream_sums_pre_cuda,
            "words": ST.stream_sums_words_cuda}
    monkeypatch.setattr(K, "stream_sums_cuda",
                        lambda x, mode="flagstat", blocks=None, out=None, zero=False:
                        seen.append(x.numel()) or real["cuda"](x, mode, blocks, out, zero))
    monkeypatch.setattr(K, "stream_sums_pre_cuda",
                        lambda t, report=False, packed=False, blocks=None, out=None, zero=False:
                        seen.append(t.shape[0] * K.GROUP_WORDS)
                        or real["pre"](t, report, packed, blocks, out, zero))
    monkeypatch.setattr(ST, "stream_sums_words_cuda",
                        lambda x, blocks=None, out=None, zero=False: seen.append(x.numel())
                        or real["words"](x, blocks, out, zero))
    step = _step(impl)
    n = (ST.DEPTH + 2) * step + 9
    x = generate_flags(n, seed=53, full_range=True)
    if impl == "pospopcnt":
        np.testing.assert_array_equal(L.pospopcnt_u16(x, impl="cuda", device="cpu"),
                                      J.pospopcnt_u16(x, impl="numpy"))
    else:
        _check(L.flagstats_u16(x, impl=impl, device="cpu"), J.flagstats_u16(x, impl="numpy"),
               impl)
    pieces = -(-n // step)
    assert len(seen) == pieces and max(seen) <= step and sum(seen) >= n
    want = [(op, k % ST.DEPTH) for k in range(pieces) for op in ("acquire", "ship", "release")]
    assert calls == want
    # the ring is made once and kept for the process, one per STAGE_WORDS
    assert list(ST._RINGS) == [(torch.device("cpu"), PIECE)]
    assert ST.ring("cpu") is ST._RINGS[(torch.device("cpu"), PIECE)]

"""Set algebra: the port's popcnt / intersect_count / union_count /
diff_count (impl "torch" on the CPU, and "native") against the JAX
package's (impl "xla" and "native") and numpy's bit count, on the same
seeded bitmaps. Exact (tolerance 0): they are integer counts."""
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import setalgebra as JS

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import native_host
from libflagstats_tpu_torch.ops import setalgebra as S

NAMES = ("popcnt", "intersect_count", "union_count", "diff_count")
NP_OPS = {"popcnt": lambda a, b: a, "intersect_count": np.bitwise_and,
          "union_count": np.bitwise_or, "diff_count": lambda a, b: a & ~b}


def _bits(x: np.ndarray) -> int:
    return int(np.bitwise_count(np.ascontiguousarray(x).view(np.uint8)).sum(dtype=np.int64))


def _port(name, a, b, **kw):
    fn = getattr(L, name)
    return fn(a, **kw) if name == "popcnt" else fn(a, b, **kw)


def _jax(name, a, b, impl):
    fn = getattr(JS, name)
    return fn(a, impl=impl) if name == "popcnt" else fn(a, b, impl=impl)


def _port_impls():
    return [{"impl": "torch"}, {"device": "cpu"}] + (
        [{"impl": "native"}] if native_host.available() else [])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n", [0, 4, 1000, 65536])
def test_counts_equal_the_jax_package(name, n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    b = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    want = _bits(NP_OPS[name](a, b))
    assert _jax(name, a, b, "xla") == want
    if JS._native_available():
        assert _jax(name, a, b, "native") == want
    for kw in _port_impls():
        got = _port(name, a, b, **kw)
        assert isinstance(got, int) and got == want, (kw, got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64, np.int16, np.int64])
def test_any_integer_view(dtype):
    rng = np.random.default_rng(11)
    raw_a = rng.integers(0, 256, size=4096, dtype=np.uint8)
    raw_b = rng.integers(0, 256, size=4096, dtype=np.uint8)
    a, b = raw_a.view(dtype), raw_b.view(dtype)
    for name in NAMES:
        want = _bits(NP_OPS[name](raw_a, raw_b))
        assert _jax(name, a, b, "xla") == want
        for kw in _port_impls():
            assert _port(name, a, b, **kw) == want, (name, kw)
        # tensors too: a bitmap may already lie on a device
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        assert _port(name, ta, tb, device="cpu") == want, name


def test_dtype_flexibility():
    a = np.array([0xFF, 0x0F], dtype=np.uint16).repeat(2)
    assert L.popcnt(a, device="cpu") == JS.popcnt(a, impl="xla") == 2 * (8 + 4)


def test_errors_are_the_jax_package_s():
    for mod, kw in ((JS, {"impl": "xla"}), (L, {"device": "cpu"})):
        with pytest.raises(ValueError, match="multiple of 4"):
            mod.popcnt(np.zeros(3, dtype=np.uint8), **kw)
        with pytest.raises(ValueError, match="equal size"):
            mod.intersect_count(np.zeros(4, np.uint32), np.zeros(8, np.uint32), **kw)
        with pytest.raises(ValueError, match="integer-typed"):
            mod.popcnt(np.zeros(4, np.float32), **kw)
    for mod in (JS, L):
        with pytest.raises(ValueError, match="unknown impl"):
            mod.union_count(np.zeros(4, np.uint32), np.zeros(4, np.uint32), impl="pallas")
    with pytest.raises(ValueError, match="integer-typed"):
        L.popcnt(torch.zeros(4), device="cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        L.popcnt(torch.zeros(3, dtype=torch.uint8), device="cpu")
    with pytest.raises(ValueError, match="4-byte aligned"):
        L.popcnt(torch.zeros(9, dtype=torch.uint8)[1:], device="cpu")


def test_plain_version_in_ragged_passes(monkeypatch):
    """The plain version walks the bitmap in passes of PLAIN_CHUNK_LANES;
    shrink it to force several passes and a ragged last one."""
    monkeypatch.setattr(S, "PLAIN_CHUNK_LANES", 1000)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, size=3777, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=3777, dtype=np.uint64).astype(np.uint32)
    for name in NAMES:
        assert _port(name, a, b, device="cpu") == _bits(NP_OPS[name](a, b)) \
            == _jax(name, a, b, "xla")


def test_all_ones_small():
    ones = np.full(1 << 16, 0xFFFFFFFF, dtype=np.uint32)
    assert L.popcnt(ones, device="cpu") == JS.popcnt(ones, impl="xla") == 32 << 16
    assert L.diff_count(ones, ones, device="cpu") == 0
    assert L.union_count(ones, ones, device="cpu") == 32 << 16


def test_two_to_the_31_set_bits():
    """2^26 all-ones lanes: the count an int32 reduce returned negative.
    The port's tally is int64 and takes it in one call per pass."""
    ones = np.full(1 << 26, 0xFFFFFFFF, dtype=np.uint32)
    assert L.popcnt(ones, device="cpu") == 1 << 31
    assert JS.popcnt(ones, impl="xla") == 1 << 31
    if native_host.available():
        assert L.intersect_count(ones, ones, impl="native") == 1 << 31


def test_wrapper_routes_only_cpu_tensors_to_plain():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, size=5000, dtype=np.int64).astype(np.int32))
    b = torch.from_numpy(rng.integers(-2**31, 2**31, size=5000, dtype=np.int64).astype(np.int32))
    before = dict(K.LAUNCHES)
    for op in native_host.SETOP_IDS:
        second = None if op == "popcnt" else b
        got = S.setop_count_cuda(a, second, op)
        assert got.shape == (1,) and got.dtype == torch.int64
        assert torch.equal(got, S.setop_count_plain(a, second, op))
    assert K.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA tensors"):
        S.setop_count_cuda(torch.zeros(8, dtype=torch.int32, device="meta"), None, "popcnt")
    with pytest.raises(ValueError, match="int32"):
        S.setop_count_cuda(a.to(torch.int64), None, "popcnt")
    with pytest.raises(ValueError, match="equal size"):
        S.setop_count_cuda(a, b[:-1], "union")
    with pytest.raises(ValueError, match="unknown op"):
        S.setop_count_cuda(a, b, "xor")
    with pytest.raises(ValueError, match="two bitmaps"):
        S.setop_count_cuda(a, None, "diff")
    with pytest.raises(ValueError, match="one bitmap"):
        S.setop_count_cuda(a, b, "popcnt")
    with pytest.raises(TypeError):
        S.setop_count_cuda(a.numpy(), None, "popcnt")


@pytest.mark.parametrize("kw", [{}, {"impl": "cuda"}, {"device": "cuda"}],
                         ids=["default", "impl", "device"])
@pytest.mark.parametrize("name", NAMES)
def test_the_card_tier_raises_without_a_device(name, kw):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    a = np.arange(64, dtype=np.uint32)
    before = dict(K.LAUNCHES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name, a, a, **kw)
    assert K.LAUNCHES == before


def test_the_default_error_names_the_ways_out():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    with pytest.raises(RuntimeError, match=r"device='cpu'.*impl='native'"):
        L.popcnt(np.arange(64, dtype=np.uint32))

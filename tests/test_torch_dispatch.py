"""The port's public API on the CPU against the JAX package's:
flagstats_u16, flagstats and pospopcnt_u16 on the same inputs, with out=
accumulation and a monkeypatched DEVICE_WORD_CAP. On the CPU the "cuda"
tiers run with device="cpu", where the kernel wrapper takes its plain
version. Exact (tolerance 0)."""
import numpy as np
import pytest
import torch

import libflagstats_tpu as J
from libflagstats_tpu.ops import dispatch as jD
from libflagstats_tpu.oracle import generate_flags

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.config import CONFIG
from libflagstats_tpu_torch.ops import dispatch as D

PORT_IMPLS = [("numpy", None), ("torch", None), ("torch", "cpu"),
              ("cuda", "cpu"), ("cuda_report", "cpu"), ("cuda_words", "cpu")]


def _check(got, want, impl):
    got = np.asarray(got, dtype=np.int64)
    want = np.asarray(want, dtype=np.int64)
    if impl == "cuda_report":
        idx = list(F.REPORT_COUNTERS)
        np.testing.assert_array_equal(got[idx], want[idx])
        assert (got[[1, 3, 4, 5, 17, 19, 20, 21]] == 0).all()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl,device", PORT_IMPLS)
@pytest.mark.parametrize("n", [0, 1, 1000, 100_003])
def test_flagstats_u16_equals_jax(impl, device, n, full_range):
    x = generate_flags(n, seed=n + 61, full_range=full_range)
    want = J.flagstats_u16(x, impl="numpy")
    got = L.flagstats_u16(x, impl=impl, device=device)
    assert got.dtype == np.uint64 and got.shape == (32,)
    _check(got, want, impl)


@pytest.mark.parametrize("impl,device", [("numpy", None), ("torch", None), ("cuda", "cpu"),
                                         ("native", None)])
def test_pospopcnt_u16_equals_jax(impl, device, full_range):
    x = generate_flags(70_001, seed=62, full_range=full_range)
    want = J.pospopcnt_u16(x, impl="numpy")
    got = L.pospopcnt_u16(x, impl=impl, device=device)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_pospopcnt_native_impl_equals_the_jax_native_impl():
    """impl="native" is a pospopcnt tier of both packages (the host
    library's AVX2 kernel), on numpy arrays and CPU tensors alike."""
    x = generate_flags(100_003, seed=63, full_range=True)
    want = J.pospopcnt_u16(x, impl="native")
    np.testing.assert_array_equal(L.pospopcnt_u16(x, impl="native"), want)
    np.testing.assert_array_equal(L.pospopcnt_u16(torch.from_numpy(x), impl="native"), want)
    np.testing.assert_array_equal(L.pospopcnt_u16(x[:0], impl="native"), np.zeros(16))


def test_flagstats_dict_equals_jax():
    x = generate_flags(50_000, seed=63, full_range=True)
    assert L.flagstats(x, device="cpu") == J.flagstats(x, impl="numpy")
    assert L.flagstats(x, impl="torch") == J.flagstats(x, impl="numpy")
    with pytest.raises(ValueError):
        L.flagstats(x.astype(np.int32))
    with pytest.raises(ValueError):
        L.flagstats(x.reshape(2, -1))


def test_counters_to_report_of_port_equals_jax():
    x = generate_flags(40_000, seed=64, full_range=True)
    want = J.counters_to_report(J.flagstats_u16(x, impl="numpy")).text()
    assert L.counters_to_report(L.flagstats_u16(x, impl="torch")).text() == want


@pytest.mark.parametrize("impl,device", PORT_IMPLS)
def test_out_accumulation_equals_jax(impl, device):
    x = generate_flags(30_011, seed=65, full_range=True)
    want = np.zeros(32, np.uint64)
    got = np.zeros(32, np.uint64)
    for block in np.array_split(x, 3):
        J.flagstats_u16(block, out=want, impl="numpy")
        L.flagstats_u16(block, out=got, impl=impl, device=device)
    _check(got, want, impl)


@pytest.mark.parametrize("impl,device", [("torch", None), ("cuda", "cpu")])
def test_device_word_cap_chunks_exactly(monkeypatch, impl, device):
    """Past DEVICE_WORD_CAP the stream splits into sub-calls, each with
    its own true length for the derived pass total (counter 9)."""
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 1000)
    monkeypatch.setattr(jD, "DEVICE_WORD_CAP", 1000)
    x = generate_flags(4321, seed=66, full_range=True)
    assert len(list(D._device_chunks(x))) == 5
    want = J.flagstats_u16(x, impl="xla")
    np.testing.assert_array_equal(want, J.flagstats_u16(x, impl="numpy"))
    np.testing.assert_array_equal(L.flagstats_u16(x, impl=impl, device=device), want)
    np.testing.assert_array_equal(L.pospopcnt_u16(x, impl=impl, device=device),
                                  J.pospopcnt_u16(x, impl="numpy"))


def test_tensor_input_and_validation():
    x = generate_flags(5000, seed=67, full_range=True)
    want = J.flagstats_u16(x, impl="numpy")
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(L.flagstats_u16(t, device="cpu"), want)
    np.testing.assert_array_equal(L.flagstats_u16(t.view(torch.int16), impl="torch"), want)
    np.testing.assert_array_equal(L.flagstats_u16(x.astype(np.int64), device="cpu"), want)
    with pytest.raises(ValueError):
        L.flagstats_u16(np.array([-1, 3]))
    with pytest.raises(ValueError):
        L.flagstats_u16(x, impl="pallas")
    with pytest.raises(ValueError):
        L.pospopcnt_u16(x, impl="cuda_report")


def test_auto_impl_is_host_without_a_device():
    """With no card, the default tier raises rather than counting on the
    host; device="cpu" asks for the CPU and gets the plain torch tier."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device tiers")
    x = generate_flags(3000, seed=68, full_range=True)
    for n in (0, 1, 1 << 30):
        for rule in (D.auto_impl, D.pospopcnt_auto_impl):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                rule(n)
            assert rule(n, device="cpu") == "torch"
            assert rule(n, device="cuda") == "cuda"
    for call in (L.flagstats_u16, L.pospopcnt_u16, L.flagstats):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(x)
    np.testing.assert_array_equal(L.flagstats_u16(x, device="cpu"),
                                  J.flagstats_u16(x, impl="numpy"))
    assert not hasattr(CONFIG, "cuda_min")
    assert set(D.FLAGSTAT_IMPLS) == {"numpy", "native", "torch", "cuda",
                                     "cuda_report", "cuda_pre", "cuda_words"}
    assert set(D.POSPOPCNT_IMPLS) == {"numpy", "native", "torch", "cuda"}

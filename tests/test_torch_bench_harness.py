"""The port's measurement harness (bench/harness.py) and reference cache
(bench/refcache.py): the gate logic as tests/test_bench_harness.py pins
it for the JAX package, the roofline's agreement protocol, the salting,
the no-card rule, and the cache's round trip and keys."""
import numpy as np
import pytest
import torch

from libflagstats_tpu_torch.bench import harness, refcache
from libflagstats_tpu_torch.bench.harness import FitResult
from libflagstats_tpu_torch.oracle import flagstat_numpy

from conftest import pospopcnt_ref


def _fit(slope_s: float, residual: float = 0.01, dispersion: float = 0.05) -> FitResult:
    return FitResult(slope_s=slope_s, intercept_s=0.05,
                     points=[(4, 0.05, 0.05), (64, 0.06, 0.06)],
                     rel_residual=residual, dispersion=dispersion, raw_slope_s=slope_s)


def _patch_fits(monkeypatch, fits):
    it = iter(fits)
    calls = []

    def fake(body_fn, x, ks=(4, 64, 260), iters=4, salt_base=None, device=None):
        calls.append(salt_base)
        return next(it)

    monkeypatch.setattr(harness, "kernel_time_fit", fake)
    return calls


def test_gated_fit_accepts_first_good_sample(monkeypatch):
    good = _fit(1e-4)
    calls = _patch_fits(monkeypatch, [good])
    assert harness.gated_kernel_time_fit(None, None) is good
    assert len(calls) == 1


def test_gated_fit_retries_past_dispersion_and_residual(monkeypatch):
    noisy, bent, good = _fit(1e-4, dispersion=0.5), _fit(1e-4, residual=0.3), _fit(1e-4)
    calls = _patch_fits(monkeypatch, [noisy, bent, good])
    assert harness.gated_kernel_time_fit(None, None) is good
    assert len(calls) == 3


def test_gated_fit_rejects_above_roofline(monkeypatch):
    impossible, plausible = _fit(1e-9), _fit(1e-6)   # 1 KiB in 1 ns is 1e12 B/s
    _patch_fits(monkeypatch, [impossible, plausible])
    got = harness.gated_kernel_time_fit(None, None, roof_bytes_per_s=500e9, n_bytes=1024)
    assert got is plausible


def test_gated_fit_returns_last_sample_when_gates_never_pass(monkeypatch):
    bad = [_fit(1e-4, dispersion=0.9) for _ in range(3)]
    calls = _patch_fits(monkeypatch, bad)
    got = harness.gated_kernel_time_fit(None, None, attempts=3)
    assert got is bad[-1] and got.dispersion >= harness.DISPERSION_MAX
    assert len(calls) == 3


def test_gated_fit_without_roofline_skips_throughput_gate(monkeypatch):
    fast = _fit(1e-9)
    _patch_fits(monkeypatch, [fast])
    assert harness.gated_kernel_time_fit(None, None, roof_bytes_per_s=None, n_bytes=1024) is fast


def test_gated_fit_sets_gate_verdict(monkeypatch):
    _patch_fits(monkeypatch, [_fit(1e-4)])
    assert harness.gated_kernel_time_fit(None, None).gate_passed is True
    _patch_fits(monkeypatch, [_fit(1e-4, dispersion=0.9) for _ in range(3)])
    assert harness.gated_kernel_time_fit(None, None, attempts=3).gate_passed is False


def test_fit_ok_gates_on_the_raw_slope():
    fit = _fit(1e-4)
    fit.raw_slope_s = -1e-4
    assert not fit.ok
    assert _fit(1e-4).ok and not _fit(1e-4, residual=0.2).ok


def test_thresholds_are_the_jax_packages():
    assert (harness.DISPERSION_MAX, harness.ROOF_MARGIN) == (0.30, 1.05)
    assert harness.HBM_NOMINAL == {"NVIDIA H100 80GB HBM3": 3.35e12}


def _patch_roofs(monkeypatch, samples):
    """roofline_fit returning one read_sum sample per attempt."""
    it = iter(samples)

    def fake(n_bytes, ks=(4, 64, 260), iters=4, device=None):
        return {"read_sum": {"bytes_per_s": next(it), "fit": _fit(1e-4)}}

    monkeypatch.setattr(harness, "roofline_fit", fake)


def test_defended_roofline_takes_the_agreeing_pair(monkeypatch):
    _patch_roofs(monkeypatch, [100.0, 200.0, 204.0])
    roof, kind = harness.defended_roofline(1 << 20, with_kind=True, device="cpu")
    assert roof == pytest.approx(202.0) and kind == "read_sum"


def test_defended_roofline_falls_back_to_the_lower_median(monkeypatch):
    _patch_roofs(monkeypatch, [100.0, 300.0])
    assert harness.defended_roofline(1 << 20, attempts=2, device="cpu") == 100.0


def test_defended_roofline_nan_without_a_sample(monkeypatch):
    monkeypatch.setattr(harness, "roofline_fit", lambda *a, **k: {
        "read_sum": {"bytes_per_s": 1.0, "fit": _fit(1e-4, dispersion=0.9)}})
    roof, kind = harness.defended_roofline(1 << 20, attempts=2, with_kind=True, device="cpu")
    assert roof != roof and kind == "none"


def test_roofline_candidates_on_the_cpu():
    out = harness.roofline_fit(1 << 16, ks=(1, 2, 3), iters=1, device="cpu")
    assert sorted(out) == ["read_sum", "read_xor_cuda"]
    assert all(v["bytes_per_s"] > 0 for v in out.values())


@pytest.mark.parametrize("dtype", [torch.int16, torch.uint16, torch.int32, torch.uint32])
def test_salted_buffer_is_new_and_xored(dtype):
    x = torch.arange(64, dtype=torch.int32).to(dtype)
    y = harness._salted(x, 0x1F0F3)
    assert y.dtype == dtype and y.data_ptr() != x.data_ptr()
    signed = torch.int16 if dtype in (torch.int16, torch.uint16) else torch.int32
    want = (torch.arange(64, dtype=torch.int32) ^ 0xF0F3).to(signed)
    assert torch.equal(y.view(signed), want)


def test_kernel_time_fit_on_the_cpu():
    x = torch.zeros(1 << 12, dtype=torch.int16)
    fit = harness.kernel_time_fit(lambda a: a.sum().view(1), x, ks=(1, 2, 3), iters=1)
    assert fit.slope_s > 0 and len(fit.points) == 3
    assert harness.kernel_time(lambda a: a.sum().view(1), x, 1, 3, iters=1) > 0


def test_no_card_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.timing_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.defended_roofline(1 << 16)
    assert harness.timing_device("cpu") == torch.device("cpu")
    assert harness.hbm_nominal_bytes_per_s("cpu") is None


def test_refcache_roundtrip_and_recompute_count(tmp_path, monkeypatch):
    x = np.array([0, 1, 2, 0x0400], dtype=np.uint16)
    calls = {"n": 0}
    real = refcache.flagstat_numpy

    def counting(arr):
        calls["n"] += 1
        return real(arr)

    monkeypatch.setattr(refcache, "flagstat_numpy", counting)
    a = refcache.oracle_counters(x, len(x), seed=7, cache_dir=str(tmp_path))
    b = refcache.oracle_counters(x, len(x), seed=7, cache_dir=str(tmp_path))
    assert calls["n"] == 1
    assert a.shape == (32,) and (a == b).all() and (a == real(x).astype(np.int64)).all()


def test_refcache_ignores_wrong_shape_file(tmp_path):
    x = np.arange(8, dtype=np.uint16)
    first = refcache.pospopcnt_counters(x, len(x), cache_dir=str(tmp_path))
    files = list(tmp_path.glob("bench_pospop_*.npy"))
    assert len(files) == 1
    np.save(files[0], np.zeros(3, dtype=np.int64))
    assert (refcache.pospopcnt_counters(x, len(x), cache_dir=str(tmp_path)) == first).all()
    assert list(first) == list(pospopcnt_ref(x))


def test_refcache_key_depends_on_semantics_source(tmp_path, monkeypatch):
    x = np.arange(16, dtype=np.uint16)
    refcache.oracle_counters(x, len(x), cache_dir=str(tmp_path))
    monkeypatch.setattr(refcache, "_source_tag", lambda: "deadbeef00")
    refcache.oracle_counters(x, len(x), cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("bench_oracle_*.npy"))) == 2


def test_refcache_key_binds_to_data(tmp_path):
    a = np.arange(16, dtype=np.uint16)
    b = a[::-1].copy()
    ra = refcache.oracle_counters(a, 16, seed=0, cache_dir=str(tmp_path))
    rb = refcache.oracle_counters(b, 16, seed=0, cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("bench_oracle_*.npy"))) == 2
    assert (ra == flagstat_numpy(a).astype(np.int64)).all()
    assert (rb == flagstat_numpy(b).astype(np.int64)).all()
    c = np.arange(32, dtype=np.uint16)[::2]
    rc = refcache.oracle_counters(c, 16, seed=1, cache_dir=str(tmp_path))
    assert (rc == flagstat_numpy(c.copy()).astype(np.int64)).all()


def test_refcache_lives_under_build_not_the_jax_cache():
    assert refcache.CACHE_DIR.endswith("build/bench_cache")
    assert ".jax_cache" not in refcache.CACHE_DIR

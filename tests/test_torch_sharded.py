"""The port's flagstat_sharded (parallel/sharded.py) over k CPU device
entries against the JAX package's flagstat_sharded on conftest's
8-device CPU mesh and flagstat_numpy, on the same seeded inputs. The
kernel impls on CPU devices run their plain versions. Exact."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from libflagstats_tpu import flags as jF
from libflagstats_tpu.ops import dispatch as jD
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu.parallel import sharded as jS

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.parallel import sharded as S

REPORT_ZEROS = [1, 3, 4, 5, 17, 19, 20, 21]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices (virtual CPU mesh)")
    return jS.data_mesh()


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("impl", S.SHARDED_IMPLS)
@pytest.mark.parametrize("n", [8, 100_000, 8 * 4096 + 5])
def test_sharded_equals_jax(mesh, n, impl, k):
    """Even and uneven tails, shards of 0 words included (n = 8 over 3)."""
    x = generate_flags(n, seed=n + 7, full_range=True)
    want = jS.flagstat_sharded(x, mesh=mesh, impl="xla")
    got = S.flagstat_sharded(x, devices=["cpu"] * k, impl=impl)
    assert got.dtype == np.uint64 and got.shape == (32,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, flagstat_numpy(x))


def test_words_kernel_on_a_two_device_mesh_equals_port(mesh):
    """The JAX word-space Pallas kernel (interpret mode) inside
    shard_map + psum on a 2-device sub-mesh, against the port's K6 plain
    version on two shards, uneven tail."""
    n = 2 * PK.WORDS_STEP - 777
    x = generate_flags(n, seed=56, full_range=True)
    small = jS.data_mesh(jax.devices()[:2])
    want = jS.flagstat_sharded(x, mesh=small, impl="pallas_words", interpret=True)
    got = S.flagstat_sharded(x, devices=["cpu", "cpu"], impl="cuda_words")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, flagstat_numpy(x))


@pytest.mark.parametrize("impl", S.SHARDED_IMPLS)
def test_report_mode(mesh, impl):
    x = generate_flags(300_001, seed=88, full_range=True)
    want = jS.flagstat_sharded(x, mesh=mesh, impl="xla", report=True).astype(np.int64)
    got = S.flagstat_sharded(x, devices=["cpu"] * 2, impl=impl, report=True).astype(np.int64)
    idx = list(jF.REPORT_COUNTERS)
    np.testing.assert_array_equal(got[idx], want[idx])
    if impl in ("cuda", "cuda_pre"):       # the 21-stream report kernels
        assert not got[REPORT_ZEROS].any()
    else:                                  # all 32 counters either way
        np.testing.assert_array_equal(got, flagstat_numpy(x).astype(np.int64))


@pytest.mark.parametrize("impl", S.SHARDED_IMPLS)
def test_device_word_cap_rounds(mesh, monkeypatch, impl):
    """Past DEVICE_WORD_CAP the column goes in accumulating rounds, each
    split over every device entry."""
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 70_000)
    monkeypatch.setattr(jD, "DEVICE_WORD_CAP", 70_000)
    x = generate_flags(300_001, seed=89, full_range=True)
    want = jS.flagstat_sharded(x, mesh=mesh, impl="xla")
    calls = []
    real = S._local_sums
    monkeypatch.setattr(S, "_local_sums",
                        lambda *a: calls.extend(w.numel() for w, _ in a[0]) or real(*a))
    np.testing.assert_array_equal(S.flagstat_sharded(x, devices=["cpu"] * 2, impl=impl), want)
    assert len(calls) == 2 * len(list(D._device_chunks(x, 65536 if impl == "cuda_pre" else 8)))
    assert len(calls) >= 4 and sum(calls) == x.size


def test_bad_input_raises():
    x = generate_flags(1000, seed=3, full_range=True)
    with pytest.raises(ValueError, match="unknown sharded impl"):
        S.flagstat_sharded(x, devices=["cpu"], impl="cuda_report")
    with pytest.raises(ValueError, match="unknown sharded impl"):
        S.flagstat_sharded(x, devices=["cpu"], impl="xla")
    with pytest.raises(ValueError):
        S.flagstat_sharded(np.array([-1, 3]), devices=["cpu"])
    with pytest.raises(ValueError):
        jS.flagstat_sharded(np.array([-1, 3]), impl="xla")
    with pytest.raises(ValueError, match="empty"):
        S.flagstat_sharded(x, devices=[])
    # a lossless integer cast and a tensor both count as their words
    want = flagstat_numpy(x)
    np.testing.assert_array_equal(S.flagstat_sharded(x.astype(np.int64), devices=["cpu"]), want)
    np.testing.assert_array_equal(S.flagstat_sharded(torch.from_numpy(x), devices=["cpu"] * 2),
                                  want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.flagstat_sharded(x)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.data_devices()


@pytest.mark.parametrize("impl", ["cuda", "cuda_pre"])
@pytest.mark.parametrize("n,parts", [(0, 3), (5, 4), (100, 3), (3 * 65536 + 5, 2), (1 << 20, 7)])
def test_shard_bounds(n, parts, impl):
    bounds = S.shard_bounds(n, parts, impl)
    granule = K.GROUP_WORDS if impl == "cuda_pre" else 8
    assert len(bounds) == parts and bounds[0][0] == 0 and bounds[-1][1] == n
    for (a, b), (c, _) in zip(bounds, bounds[1:]):
        assert a <= b == c and b % granule == 0
    assert max(b - a for a, b in bounds) <= -(-n // parts) + granule


def test_flagstat_sharded_is_a_lazy_top_level_name():
    """The package exports flagstat_sharded as the JAX package does, and
    loads parallel/ only at its first call."""
    code = ("import sys, numpy as np, libflagstats_tpu_torch as L\n"
            "assert not any(m.startswith('libflagstats_tpu_torch.parallel') for m in sys.modules)\n"
            "x = np.arange(1000, dtype=np.uint16)\n"
            "c = L.flagstat_sharded(x, devices=['cpu', 'cpu'], impl='cuda')\n"
            "assert 'libflagstats_tpu_torch.parallel.sharded' in sys.modules\n"
            "print(c.tolist())")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    x = np.arange(1000, dtype=np.uint16)
    assert eval(r.stdout.strip().splitlines()[-1]) == flagstat_numpy(x).tolist()
    for impl in ("cuda", "cuda_words", "torch"):
        y = generate_flags(30_001, seed=64, full_range=True)
        np.testing.assert_array_equal(
            L.flagstat_sharded(y, devices=["cpu"] * 3, impl=impl),
            S.flagstat_sharded(y, devices=["cpu"] * 3, impl=impl))

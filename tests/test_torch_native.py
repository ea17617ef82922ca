"""The port's native host library: its own loader builds the JAX package's
C++ sources (either zstd route), its ``native`` tier equals the JAX
package's, the new dispatch impls agree with the oracle, nothing falls
back to the CPU without a card, and none of it imports jax."""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libflagstats_tpu.io import codec as jC
from libflagstats_tpu.ops import native_host as jN
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.io import codec as tC
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import native_host as tN

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def framed(tmp_path_factory):
    x = generate_flags(1_200_003, seed=101, full_range=True)
    path = tmp_path_factory.mktemp("n") / "n.lz4"
    jC.write_framed(path, x, codec="lz4", level=1, block_bytes=1 << 17)
    return path, x


def test_native_tier_equals_jax(framed):
    path, x = framed
    assert tN.available(), native_lib.BUILD_ERROR
    np.testing.assert_array_equal(tN.flagstat_native(x, threads=2), jN.flagstat_native(x))
    np.testing.assert_array_equal(tN.pospopcnt_native(x), jN.pospopcnt_native(x))
    acc = np.zeros(32, np.uint64)
    for part in np.array_split(x, 3):
        tN.flagstat_native(part, out=acc, threads=1)
    np.testing.assert_array_equal(acc, flagstat_numpy(x))
    got, n = tN.flagstat_framed_native(path, jC.CODEC_LZ4, threads=2)
    assert n == x.size
    np.testing.assert_array_equal(got, jN.flagstat_framed_native(path, jC.CODEC_LZ4)[0])
    frames = tC.scan_frames(path)
    ranges = [tN.flagstat_framed_range_native(path, jC.CODEC_LZ4, a, b, frames=frames)
              for a, b in tC.shard_block_ranges(len(frames), 3)]
    np.testing.assert_array_equal(sum(c for c, _ in ranges), flagstat_numpy(x))
    assert sum(n for _, n in ranges) == x.size
    with pytest.raises(ValueError, match="out must be"):
        tN.flagstat_native(x, out=np.zeros(32, np.int64))
    with pytest.raises(ValueError, match="outside"):
        tN.flagstat_framed_range_native(path, jC.CODEC_LZ4, 2, len(frames) + 1)


@pytest.mark.parametrize("impl,kw", [("native", {}), ("cuda_pre", {"device": "cpu"})],
                         ids=["native", "cuda_pre"])
def test_dispatch_impls_equal_oracle(impl, kw):
    for n in (0, 1, 65_537, 200_001):
        x = generate_flags(n, seed=n, full_range=True)
        np.testing.assert_array_equal(L.flagstats_u16(x, impl=impl, **kw), flagstat_numpy(x))
    x = generate_flags(70_000, seed=3)
    acc = np.zeros(32, np.uint64)
    L.flagstats_u16(torch.from_numpy(x), out=acc, impl=impl, **kw)
    np.testing.assert_array_equal(acc, flagstat_numpy(x))


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")


@pytest.mark.parametrize("call", [
    lambda p: L.flagstat_stream(p, "lz4", impl="cuda_pre"),
    lambda p: L.flagstat_stream(p, "lz4", impl="cuda"),
    lambda p: L.flagstat_stream(p, "lz4", impl="cuda_pre", device="cuda"),
    lambda p: L.flagstats_u16(generate_flags(3000, seed=1), impl="cuda_pre"),
], ids=["stream-cuda_pre", "stream-cuda", "stream-device", "flagstats_u16-cuda_pre"])
def test_kernel_paths_raise_without_a_device(framed, call):
    _no_cuda()
    before = dict(K.LAUNCHES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(framed[0])
    assert K.LAUNCHES == before


def test_compat_zstd_route_builds(monkeypatch, tmp_path):
    """Where the system has libzstd.so.1 but no <zstd.h>, the build takes
    the port's declaration-only header; its library round-trips zstd."""
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_lib, "ZSTD_ROUTE", None)
    monkeypatch.setattr(native_lib, "_zstd_flags", lambda: (
        "compat", ["-I", str(native_lib.COMPAT_DIR)], ["-l:libzstd.so.1"]))
    lib = native_lib._bind(ctypes.CDLL(str(native_lib.build())))
    assert native_lib.ZSTD_ROUTE == "compat"
    data = generate_flags(40_000, seed=5).tobytes()
    blob = jC.compress_block(data, "zstd", level=3)
    dst = ctypes.create_string_buffer(len(data))
    assert lib.lfs_zstd_decompress(blob, len(blob), dst, len(data)) == len(data)
    assert dst.raw == data


@pytest.mark.parametrize("n_bytes", [0, 4, 7, 1000, 100_001 * 4 + 3])
def test_setop_count_native_equals_jax(n_bytes):
    """The host POPCNT counts, byte tails that are no whole word included."""
    assert tN.SETOP_IDS == jN.SETOP_IDS
    rng = np.random.default_rng(n_bytes)
    a = rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    b = rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    ops = {"intersect": a & b, "union": a | b, "diff": a & ~b, "popcnt": a}
    for op, combined in ops.items():
        second = None if op == "popcnt" else b
        want = int(np.bitwise_count(combined).sum(dtype=np.int64))
        assert tN.setop_count_native(a, second, op, threads=2) == want
        assert jN.setop_count_native(a, second, op) == want
    with pytest.raises(KeyError):
        tN.setop_count_native(a, b, "xor")


def test_failed_build_returns_none_and_keeps_stderr(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_lib, "SOURCES", (bad,))
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_lib, "_lib", None)
    monkeypatch.setattr(native_lib, "BUILD_ERROR", "")
    assert native_lib.load() is None
    assert "g++ failed" in native_lib.BUILD_ERROR and "broken.cpp" in native_lib.BUILD_ERROR
    assert not tN.available()
    with pytest.raises(RuntimeError, match="native host library unavailable"):
        tN.flagstat_native(np.zeros(4, np.uint16))


def test_host_library_and_stream_pull_in_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import libflagstats_tpu_torch as L\n"
        "from libflagstats_tpu_torch.io import codec, native_lib\n"
        "from libflagstats_tpu_torch.oracle import generate_flags, flagstat_numpy\n"
        "assert native_lib.load() is not None, native_lib.BUILD_ERROR\n"
        "x = generate_flags(100_000, seed=1, full_range=True)\n"
        f"p = {str(tmp_path / 'j.lz4')!r}\n"
        "codec.write_framed(p, x, 'lz4', 1)\n"
        "for impl, kw in (('native', {}), ('cuda_pre', {'device': 'cpu'})):\n"
        "    got = L.flagstat_stream(p, 'lz4', impl=impl, chunk_words=65536, **kw)\n"
        "    assert (got == flagstat_numpy(x)).all(), impl\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'libflagstats_tpu'))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr

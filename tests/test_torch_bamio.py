"""The port's BAM module (io/bamio.py) against the JAX package's on the
same seeded inputs, tolerance 0: write_bam writes the same bytes, each
package reads the other's files to the same column, both reject the
same corrupt containers, the byte-range shards and flagstat_bam equal
the JAX functions and the oracle, and the readers built to inflate
with zlib alone read what the default build reads."""
import ctypes

import numpy as np
import pytest

from libflagstats_tpu.io import bamio as jbam
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.io import bamio as tbam
from libflagstats_tpu_torch.io import native_lib


@pytest.fixture(scope="module")
def words():
    return generate_flags(200_003, seed=91, full_range=True)


@pytest.fixture(scope="module")
def bams(tmp_path_factory, words):
    d = tmp_path_factory.mktemp("bam")
    files = {"minimal": d / "m.bam", "realistic": d / "r.bam"}
    jbam.write_bam(files["minimal"], words, block_bytes=20_000)
    jbam.write_bam(files["realistic"], words[:60_000], payload="realistic", seed=4, level=1)
    return files


@pytest.mark.parametrize("kw", [{}, {"level": 1, "block_bytes": 65_536},
                                {"read_name": b"read_name_x", "threads": 1},
                                {"payload": "realistic", "seed": 7},
                                {"payload": "realistic", "level": 9, "block_bytes": 9_000}])
def test_write_bam_bytes_equal_jax(tmp_path, kw):
    x = generate_flags(40_001, seed=92, full_range=True)
    a, b = tmp_path / "j.bam", tmp_path / "t.bam"
    assert jbam.write_bam(a, x, **kw) == tbam.write_bam(b, x, **kw) == x.size
    assert a.read_bytes() == b.read_bytes()
    assert tbam._bgzf_member(b"abc" * 99, level=3) == jbam._bgzf_member(b"abc" * 99, level=3)
    assert tbam.BGZF_EOF == jbam.BGZF_EOF and tbam.REALISTIC_REC_LEN == jbam.REALISTIC_REC_LEN


@pytest.mark.parametrize("kind", ["minimal", "realistic"])
def test_readers_equal_jax(bams, words, kind):
    path = bams[kind]
    want = words[:60_000] if kind == "realistic" else words
    np.testing.assert_array_equal(jbam.read_bam_flags(path), want)
    np.testing.assert_array_equal(tbam.read_bam_flags(path, threads=3), want)
    assert tbam.READ_ROUTE == "native"
    np.testing.assert_array_equal(tbam.read_bam_flags_py(path), want)
    np.testing.assert_array_equal(tbam.read_bam_flags_py(path, max_records=99),
                                  jbam.read_bam_flags_py(path, max_records=99))


def test_the_jax_package_reads_the_ports_files(tmp_path, words):
    p = tmp_path / "t.bam"
    tbam.write_bam(p, words, payload="realistic", level=1)
    np.testing.assert_array_equal(jbam.read_bam_flags(p), words)
    np.testing.assert_array_equal(jbam.flagstat_bam(p), flagstat_numpy(words))


def _corrupt(tmp_path):
    x = generate_flags(30_000, seed=93, full_range=True)
    good = tmp_path / "good.bam"
    jbam.write_bam(good, x)
    data = good.read_bytes()
    cases = {"truncated": data[:len(data) // 2], "not gzip": b"\x00" * 1000, "empty": b"",
             "bgzf, not BAM": jbam._bgzf_member(b"nope" * 10) + jbam.BGZF_EOF}
    paths = {}
    for name, blob in cases.items():
        paths[name] = tmp_path / f"{name.replace(' ', '_').replace(',', '')}.bam"
        paths[name].write_bytes(blob)
    return paths


@pytest.mark.parametrize("name", ["truncated", "not gzip", "bgzf, not BAM", "empty"])
def test_corrupt_containers_raise_as_in_jax(tmp_path, name):
    path = _corrupt(tmp_path)[name]
    for read in (jbam.read_bam_flags, tbam.read_bam_flags):
        with pytest.raises(ValueError):
            read(path)
    errors = (ValueError, EOFError, OSError)
    for read in (jbam.read_bam_flags_py, tbam.read_bam_flags_py):
        with pytest.raises(errors):
            read(path)
    with pytest.raises(ValueError):
        tbam.flagstat_bam(path, impl="native")
    with pytest.raises(ValueError):
        tbam.flagstat_bam(path, device="cpu")


def test_byte_ranges_equal_jax(bams, words):
    path = bams["minimal"]
    raw = tbam.bam_raw_size(path)
    assert raw == jbam.bam_raw_size(path) > 0
    cuts = [0, raw // 5, raw // 2, raw - 1000, raw]
    total = np.zeros(32, np.uint64)
    n_records, end = 0, None
    for lo, hi in zip(cuts, cuts[1:]):
        got = tbam.flagstat_bam_byte_range(path, lo, hi, threads=2)
        want = jbam.flagstat_bam_byte_range(path, lo, hi, threads=2)
        assert got is not None and got[1:] == want[1:]
        np.testing.assert_array_equal(got[0], want[0])
        assert end is None or got[2] == end        # the shards chain exactly
        end = got[3]
        total += got[0]
        n_records += got[1]
    assert n_records == words.size and end == raw
    np.testing.assert_array_equal(total, flagstat_numpy(words))


@pytest.mark.parametrize("kind", ["minimal", "realistic"])
@pytest.mark.parametrize("impl,device", [(None, "cpu"), ("native", None), ("numpy", None),
                                         ("cuda", "cpu"), ("cuda_pre", "cpu"),
                                         ("cuda_words", "cpu")])
def test_flagstat_bam_equals_jax_and_oracle(bams, words, kind, impl, device):
    path = bams[kind]
    want = flagstat_numpy(words[:60_000] if kind == "realistic" else words)
    got = tbam.flagstat_bam(path, threads=2, impl=impl, device=device)
    np.testing.assert_array_equal(got, jbam.flagstat_bam(path, threads=2))
    np.testing.assert_array_equal(got, want)


def test_python_route_without_the_readers_is_stated(bams, words, monkeypatch, capsys):
    monkeypatch.setattr(native_lib, "load_readers", lambda: None)
    monkeypatch.setattr(native_lib, "READERS_BUILD_ERROR", "RuntimeError: g++ failed (test)")
    np.testing.assert_array_equal(tbam.read_bam_flags(bams["minimal"]), words)
    assert tbam.READ_ROUTE == "python"
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "Python reader" in err[0] and "g++ failed (test)" in err[0]
    np.testing.assert_array_equal(tbam.flagstat_bam(bams["minimal"], device="cpu"),
                                  flagstat_numpy(words))
    for call in (lambda p: tbam.flagstat_bam(p, impl="native"), tbam.bam_raw_size,
                 lambda p: tbam.flagstat_bam_byte_range(p, 0, 100)):
        with pytest.raises(RuntimeError, match="readers did not build"):
            call(bams["minimal"])


def test_zlib_inflate_route_reads_what_the_default_route_reads(monkeypatch, tmp_path, bams, words):
    """The readers and the column readers built to inflate with zlib
    alone (``-DLFS_NO_LIBDEFLATE``, the route of a host with no
    libdeflate) walk the BAM to the default build's column and
    counters."""
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_lib, "DEFLATE_ROUTE", None)    # restored after the test
    monkeypatch.setattr(native_lib, "_deflate_flags", lambda: ("zlib", ["-DLFS_NO_LIBDEFLATE"], []))
    lib = native_lib._bind_readers(ctypes.CDLL(str(native_lib.build_readers())))
    columns = native_lib._bind_columns(ctypes.CDLL(str(native_lib.build_columns())))
    assert native_lib.DEFLATE_ROUTE == "zlib"
    monkeypatch.setattr(native_lib, "load_readers", lambda: lib)
    monkeypatch.setattr(native_lib, "load_columns", lambda: columns)
    for kind, want in (("minimal", words), ("realistic", words[:60_000])):
        np.testing.assert_array_equal(tbam.read_bam_flags(bams[kind], threads=2), want)
        np.testing.assert_array_equal(tbam.flagstat_bam(bams[kind], impl="native"),
                                      flagstat_numpy(want))

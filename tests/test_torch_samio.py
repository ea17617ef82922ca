"""The port's SAM module (io/samio.py) against the JAX package's on the
same seeded inputs, tolerance 0: the writers write the same bytes, the
readers (native and Python) read the same columns from plain, gzip and
BGZF SAM and from a bare column, reject the same malformed lines, and
the member-range counts and flagstat_sam equal the JAX functions and
the oracle. Where the native readers did not build, the Python reader
is taken and says so; ``impl="native"`` raises instead."""
import gzip
import io

import numpy as np
import pytest

from libflagstats_tpu.io import bamio as jbam
from libflagstats_tpu.io import samio as jsam
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.io import samio as tsam


def _bgzf(data: bytes, path, member: int = 60_000) -> None:
    with open(path, "wb") as fh:
        for off in range(0, len(data), member):
            fh.write(jbam._bgzf_member(data[off:off + member], level=1))
        fh.write(jbam.BGZF_EOF)


@pytest.fixture(scope="module")
def words():
    return generate_flags(150_001, seed=81, full_range=True)


@pytest.fixture(scope="module")
def sam_files(tmp_path_factory, words):
    """Every SAM kind of one column: plain (minimal and realistic), plain
    gzip, BGZF, and the bare column as text."""
    d = tmp_path_factory.mktemp("sam")
    files = {"plain": d / "t.sam", "realistic": d / "r.sam", "gzip": d / "t.sam.gz",
             "bgzf": d / "b.sam.gz", "column": d / "col.txt"}
    jsam.write_sam(files["plain"], words)
    jsam.write_sam(files["realistic"], words, payload="realistic", seed=3)
    files["gzip"].write_bytes(gzip.compress(files["plain"].read_bytes(), mtime=0))
    _bgzf(files["realistic"].read_bytes(), files["bgzf"])
    files["column"].write_text("\n".join(map(str, words.tolist())) + "\n")
    return files


@pytest.mark.parametrize("payload,header", [("minimal", True), ("minimal", False),
                                            ("realistic", True)])
def test_write_sam_bytes_equal_jax(tmp_path, payload, header):
    x = generate_flags(70_003, seed=82, full_range=True)
    a, b = tmp_path / "j.sam", tmp_path / "t.sam"
    assert jsam.write_sam(a, x, with_header=header, payload=payload, seed=9) == x.size
    assert tsam.write_sam(b, x, with_header=header, payload=payload, seed=9) == x.size
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("full_range", [False, True])
def test_generators_equal_jax(tmp_path, full_range):
    j, t = io.StringIO(), io.StringIO()
    jsam.generate_text(1001, j, seed=5, full_range=full_range)
    tsam.generate_text(1001, t, seed=5, full_range=full_range)
    assert j.getvalue() == t.getvalue()
    a, b = tmp_path / "j.bin", tmp_path / "t.bin"
    np.testing.assert_array_equal(jsam.generate_binary(50_000, a, seed=6, full_range=full_range),
                                  tsam.generate_binary(50_000, b, seed=6, full_range=full_range))
    assert a.read_bytes() == b.read_bytes()
    for mod in (jsam, tsam):
        np.testing.assert_array_equal(mod.read_binary(b), np.fromfile(a, dtype="<u2"))
        np.testing.assert_array_equal(mod.read_binary(b, mmap=False), np.fromfile(a, "<u2"))


@pytest.mark.parametrize("chunk", [1, 7, 1 << 24])
def test_text_to_binary_equals_jax(chunk):
    text = "77 99\n4095\t0\n65535\n\n12 3"
    outs = []
    for mod in (jsam, tsam):
        out = io.BytesIO()
        assert mod.text_to_binary(io.StringIO(text), out, chunk_chars=chunk) == 7
        outs.append(out.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kind", ["plain", "realistic", "gzip", "bgzf", "column"])
def test_readers_equal_jax(sam_files, words, kind):
    path = sam_files[kind]
    assert tsam.is_gzip(path) == jsam.is_gzip(path) == (kind in ("gzip", "bgzf"))
    want = jsam.read_sam_flags(path, threads=3)
    np.testing.assert_array_equal(want, words)
    np.testing.assert_array_equal(tsam.read_sam_flags(path, threads=3), want)
    assert tsam.READ_ROUTE == "native"
    np.testing.assert_array_equal(tsam.read_sam_flags_py(path), jsam.read_sam_flags_py(path))


EDGES = {
    "header only": b"@HD\tVN:1.6\n@SQ\tSN:c\tLN:5\n",
    "empty": b"",
    "no trailing newline": b"r1\t77\t*\t0\t0\t*\t*\t0\t0\t*\t*",
    "crlf and empty lines": b"r1\t65535\t*\r\nr2\t0\t*\r\n\r\n",
    "bare column": b"77\n0\n65535\n",
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_shapes_equal_jax(tmp_path, name):
    p = tmp_path / "e.sam"
    p.write_bytes(EDGES[name])
    want = jsam.read_sam_flags_py(p)
    for got in (tsam.read_sam_flags(p), tsam.read_sam_flags_py(p), jsam.read_sam_flags(p)):
        np.testing.assert_array_equal(got, want)


MALFORMED = ["r1\tx77\t*\n", "r1\t65536\t*\n", "r1\t7 7\t*\n", "r1\t\t*\n",
             "readname_no_tab_not_a_number\n", "r1\t77\r\r\n"]


@pytest.mark.parametrize("body", MALFORMED)
def test_malformed_lines_raise_as_in_jax(tmp_path, body):
    p = tmp_path / "bad.sam"
    p.write_text(body)
    for read in (jsam.read_sam_flags_py, jsam.read_sam_flags, tsam.read_sam_flags_py,
                 tsam.read_sam_flags):
        with pytest.raises(ValueError):
            read(p)
    with pytest.raises(ValueError):
        tsam.flagstat_sam(p, impl="native")


def test_member_ranges_equal_jax(sam_files, words):
    path = sam_files["bgzf"]
    n = tsam.bgzf_member_count(path)
    assert n == jsam.bgzf_member_count(path) >= 64
    ref = flagstat_numpy(words)
    total = np.zeros(32, np.uint64)
    # uneven ranges: line ownership at every boundary must be exact
    for a, b in ((0, 1), (1, 17), (17, n // 2), (n // 2, n)):
        got = tsam.flagstat_sam_range(path, a, b, threads=2)
        np.testing.assert_array_equal(got, jsam.flagstat_sam_range(path, a, b, threads=2))
        total += got
    np.testing.assert_array_equal(total, ref)
    np.testing.assert_array_equal(tsam.flagstat_sam_range(path, 5, 5), np.zeros(32, np.uint64))
    split = tsam._flagstat_bgzf_sam_parallel(path, threads=4)
    assert split is not None
    np.testing.assert_array_equal(split, ref)
    with pytest.raises(ValueError):
        tsam.bgzf_member_count(sam_files["gzip"])   # gzip, not BGZF


@pytest.mark.parametrize("kind", ["plain", "gzip", "bgzf"])
@pytest.mark.parametrize("impl,device", [(None, "cpu"), ("native", None), ("numpy", None),
                                         ("cuda", "cpu"), ("cuda_words", "cpu")])
def test_flagstat_sam_equals_jax_and_oracle(sam_files, words, kind, impl, device):
    path = sam_files[kind]
    got = tsam.flagstat_sam(path, threads=2, impl=impl, device=device)
    np.testing.assert_array_equal(got, jsam.flagstat_sam(path, threads=2))
    np.testing.assert_array_equal(got, flagstat_numpy(words))


@pytest.fixture
def no_readers(monkeypatch):
    monkeypatch.setattr(native_lib, "load_readers", lambda: None)
    monkeypatch.setattr(native_lib, "READERS_BUILD_ERROR", "RuntimeError: g++ failed (test)")


@pytest.mark.parametrize("kind", ["plain", "bgzf"])
def test_python_route_without_the_readers_is_stated(sam_files, words, no_readers, capsys, kind):
    np.testing.assert_array_equal(tsam.read_sam_flags(sam_files[kind]), words)
    assert tsam.READ_ROUTE == "python"
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "Python reader" in err[0] and "g++ failed (test)" in err[0]
    with pytest.raises(RuntimeError, match="readers did not build"):
        tsam.flagstat_sam(sam_files[kind], impl="native")
    with pytest.raises(RuntimeError, match="readers did not build"):
        tsam.bgzf_member_count(sam_files[kind])

"""The port's CRAM module (io/cramio.py) against the JAX package's on the
same seeded inputs, tolerance 0, case for case with tests/test_cramio.py:
itf8/ltf8 at their edges (native = Python), write_cram's bytes for the
RAW, GZIP and RANS methods at one and many containers, each package reading the
other's files, read_cram_flags and flagstat_cram in every tier (the
kernel impls through their plain versions on the CPU) = JAX = the
oracle, the subset's refusals on every reader (the Python walk in the
JAX package's words, the fused walker and the container column reader
behind read_cram_flags with the same rc), truncations and byte flips
that never miscount, the columnar skip, container ranges summing to
the whole, the stated Python route without the readers, and the raise
before reading when there is no card."""
import re
import struct
import zlib

import numpy as np
import pytest
import torch

import libflagstats_tpu as J
from libflagstats_tpu.io import cramio as jcram
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.io import cramio as tcram
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.io import read_flags_auto, sniff_format
from libflagstats_tpu_torch.ops import kernels as K

METHODS = {"raw": tcram.RAW, "gzip": tcram.GZIP, "rans": tcram.RANS}


@pytest.fixture(scope="module")
def words():
    return generate_flags(150_001, seed=81, full_range=True)


@pytest.fixture(scope="module")
def crams(tmp_path_factory, words):
    """The column in five containers, one file per method, written by
    the JAX package."""
    d = tmp_path_factory.mktemp("cram")
    files = {}
    for name, method in METHODS.items():
        files[name] = d / f"{name}.cram"
        jcram.write_cram(files[name], words, records_per_container=40_000, method=method)
    return files


def _fused(path, threads=2):
    return tcram.flagstat_cram(path, threads=threads, impl="native")


# ---- itf8 / ltf8 ----

def test_itf8_roundtrip_edges():
    vals = np.array([0, 1, 127, 128, 0x3FFF, 0x4000, 0x1FFFFF, 0x200000,
                     0xFFFFFFF, 0x10000000, 0x7FFFFFFF, -1, -(2 ** 31)], dtype=np.int64)
    enc = b"".join(tcram.itf8_encode(int(v)) for v in vals)
    assert enc == tcram.itf8_encode_stream(vals) == jcram.itf8_encode_stream(vals)
    dec = tcram.itf8_decode_stream(enc, len(vals))
    np.testing.assert_array_equal(dec, jcram.itf8_decode_stream(enc, len(vals)))
    np.testing.assert_array_equal(dec.astype(np.int64), vals.astype(np.int32).astype(np.int64))
    for v in vals.tolist():
        e = tcram.itf8_encode(v)
        assert tcram.itf8_decode(e, 0) == jcram.itf8_decode(e, 0)
    with pytest.raises(ValueError, match="trailing"):
        tcram.itf8_decode_stream(enc + b"\x00", len(vals))
    with pytest.raises(ValueError, match="truncated"):
        tcram.itf8_decode_stream(enc[:-1], len(vals))


def test_itf8_python_route_matches_native(monkeypatch):
    vals = np.array([5, 200, 70000, 2 ** 24, -3], dtype=np.int64)
    enc = tcram.itf8_encode_stream(vals)
    assert native_lib.load() is not None
    native = tcram.itf8_decode_stream(enc, len(vals))
    monkeypatch.setattr(native_lib, "load", lambda: None)
    pure = tcram.itf8_decode_stream(enc, len(vals))
    np.testing.assert_array_equal(native, pure)
    for bad in (enc + b"\x01", enc[:-2]):
        with pytest.raises(ValueError):
            tcram.itf8_decode_stream(bad, len(vals))


def test_ltf8_roundtrip():
    for v in (0, 1, 127, 128, 1 << 13, 1 << 20, 1 << 34, 1 << 50, (1 << 63) - 1, -1):
        e = tcram.ltf8_encode(v)
        assert e == jcram.ltf8_encode(v)
        got, off = tcram.ltf8_decode(e, 0)
        assert (got, off) == jcram.ltf8_decode(e, 0)
        assert off == len(e) and got == v
    with pytest.raises(ValueError, match="truncated"):
        tcram.ltf8_decode(b"\xff\x00", 0)


def test_eof_container_is_structurally_valid():
    assert tcram.EOF_CONTAINER == jcram.EOF_CONTAINER
    hdr, off = tcram._parse_container_header(memoryview(tcram.EOF_CONTAINER), 0)
    assert hdr["n_records"] == 0 and hdr["n_blocks"] == 1
    blk, _ = tcram._read_block(
        memoryview(tcram.EOF_CONTAINER)[hdr["body"][0]:hdr["body"][1]], 0)
    assert blk["ctype"] == tcram.CT_COMPRESSION_HEADER
    assert off == len(tcram.EOF_CONTAINER)


# ---- the writer and the readers ----

@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("rpc", [1 << 20, 7_000, 1_000])
def test_write_cram_bytes_equal_jax(tmp_path, method, rpc):
    """One, five and 31 containers: the port encodes them on a thread
    pool and writes the JAX package's bytes."""
    x = generate_flags(30_001, seed=82, full_range=True)
    a, b = tmp_path / "j.cram", tmp_path / "t.cram"
    assert jcram.write_cram(a, x, records_per_container=rpc, method=METHODS[method]) == \
        tcram.write_cram(b, x, records_per_container=rpc, method=METHODS[method]) == x.size
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("method", sorted(METHODS))
def test_each_package_reads_the_others_files(tmp_path, crams, words, method):
    np.testing.assert_array_equal(tcram.read_cram_flags(crams[method], threads=3), words)
    assert tcram.READ_ROUTE == "native"
    np.testing.assert_array_equal(tcram.read_cram_flags(crams[method], threads=1), words)
    p = tmp_path / "t.cram"
    tcram.write_cram(p, words, records_per_container=33_333, method=METHODS[method])
    np.testing.assert_array_equal(jcram.read_cram_flags(p), words)
    np.testing.assert_array_equal(jcram.flagstat_cram(p), flagstat_numpy(words))


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 4096, 4097])
def test_read_cram_flags_edge_sizes(tmp_path, n):
    """Empty, one word, and one word either side of a container boundary
    (1024 records a container)."""
    x = generate_flags(n, seed=n, full_range=True)
    p = tmp_path / "e.cram"
    tcram.write_cram(p, x, records_per_container=1024)
    assert tcram.data_container_count(p) == jcram.data_container_count(p) == -(-n // 1024)
    got = tcram.read_cram_flags(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, jcram.read_cram_flags(p))
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(tcram.flagstat_cram(p, impl="native"), flagstat_numpy(x))
    np.testing.assert_array_equal(tcram.flagstat_cram(p, device="cpu"), flagstat_numpy(x))


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("impl,device", [(None, "cpu"), ("numpy", None), ("native", None),
                                         ("torch", None), ("cuda", "cpu"), ("cuda_pre", "cpu"),
                                         ("cuda_words", "cpu")])
def test_flagstat_cram_equals_jax_and_oracle(crams, words, method, impl, device):
    path = crams[method]
    before = dict(K.LAUNCHES)
    got = tcram.flagstat_cram(path, threads=2, impl=impl, device=device)
    assert K.LAUNCHES == before                 # the plain versions on the CPU
    np.testing.assert_array_equal(got, jcram.flagstat_cram(path, threads=2))
    np.testing.assert_array_equal(got, flagstat_numpy(words))


def test_sniff_and_flagstat_file(crams, words):
    path = crams["gzip"]
    assert sniff_format(path) == J.io.sniff_format(path) == "cram"
    np.testing.assert_array_equal(read_flags_auto(path), J.io.read_flags_auto(path))
    got = L.flagstat_file(path, device="cpu")
    np.testing.assert_array_equal(got, J.flagstat_file(path))
    np.testing.assert_array_equal(L.flagstat_file(path, impl="native"), got)
    np.testing.assert_array_equal(got, flagstat_numpy(words))


def test_cli_flagstat_and_bam2flags_cram(tmp_path, capsys):
    from libflagstats_tpu import cli as jcli
    from libflagstats_tpu_torch import cli as tcli

    x = generate_flags(20_000, seed=8, full_range=True)
    p = tmp_path / "t.cram"
    tcram.write_cram(p, x)
    assert jcli.main(["flagstat", str(p)]) == 0
    want = capsys.readouterr().out
    for extra in (["--device", "cpu"], ["--impl", "native"]):
        assert tcli.main(["flagstat", str(p), *extra]) == 0
        assert capsys.readouterr().out == want
    assert tcli.main(["bam2flags", str(p), "-o", str(tmp_path / "f.bin")]) == 0
    np.testing.assert_array_equal(np.fromfile(tmp_path / "f.bin", dtype="<u2"), x)


# ---- refusals: every reader raises, none guesses ----

def _raise_message(call, path) -> str:
    with pytest.raises(ValueError) as e:
        call(path)
    return str(e.value)


def _rc(message: str) -> str:
    """The "(rc=N)" of a native walker's or reader's refusal."""
    return re.search(r"\(rc=-?\d+\)", message).group(0)


def _column_refuses_as_the_fused_walker(p) -> None:
    """The column reader (read_cram_flags, flagstat_cram and
    flagstat_cram_range on the card route) raises the fused walker's
    ValueError: the same rc, in the same words."""
    fused = _raise_message(_fused, p)
    assert fused.startswith("lfs_cram_flagstat failed (rc=")
    assert fused == _raise_message(jcram.flagstat_cram, p)
    column = _raise_message(tcram.read_cram_flags, p)
    assert tcram.READ_ROUTE == "native"
    assert re.match(r"lfs_cram_(flags_range|range_records) failed \(rc=", column), column
    assert column.split(" failed ")[1] == fused.split(" failed ")[1]
    for call in (lambda q: tcram.flagstat_cram(q, device="cpu"),
                 lambda q: tcram.flagstat_cram_range(q, 0, 1, device="cpu")):
        assert _rc(_raise_message(call, p)) == _rc(fused)


def test_bad_magic_and_version(tmp_path):
    p = tmp_path / "x.cram"
    for blob, match in ((b"CRAX" + b"\x00" * 30, "not a CRAM"),
                        (b"CRAM\x02\x01" + b"\x00" * 30, "unsupported")):
        p.write_bytes(blob)
        msg = _raise_message(tcram.read_cram_flags_py, p)
        assert match in msg and msg == _raise_message(jcram.read_cram_flags, p)
        _column_refuses_as_the_fused_walker(p)
    p.write_bytes(b"")      # the fused walkers map no empty file: they read its column
    assert _raise_message(tcram.read_cram_flags_py, p) == \
        _raise_message(jcram.read_cram_flags, p) == "not a CRAM file"
    assert _rc(_raise_message(tcram.read_cram_flags, p)) == "(rc=-2)"


def _patch_series_codec(m, mod):
    """A BF series with a non-EXTERNAL encoding (HUFFMAN, 3)."""
    def bad_header(method):
        pres = mod._write_map([(b"RN", b"\x01")])
        ds = mod._write_map([
            (b"BF", mod.itf8_encode(3) + mod.itf8_encode(0)),
            (b"CF", mod.itf8_encode(mod.ENC_EXTERNAL) + mod.itf8_encode(1)
             + mod.itf8_encode(mod.ID_CF))])
        return mod._write_block(mod.RAW, mod.CT_COMPRESSION_HEADER, 0,
                                pres + ds + mod._write_map([]))
    m.setattr(mod, "_compression_header_block", bad_header)


def _patch_block_method(m, mod):
    """Series blocks in a compression method outside raw/gzip/rANS
    (bzip2, 2)."""
    write = mod._write_block

    def bzip_block(method, ctype, content_id, data):
        if ctype != mod.CT_EXTERNAL:
            return write(method, ctype, content_id, data)
        body = (bytes([2, ctype]) + mod.itf8_encode(content_id)
                + mod.itf8_encode(len(data)) + mod.itf8_encode(len(data)) + data)
        return body + struct.pack("<I", zlib.crc32(body))
    m.setattr(mod, "_write_block", bzip_block)


def _patch_mate_downstream(m, mod):
    """Within-slice mate linking (CF 0x4, not detached)."""
    m.setattr(mod, "CF_DETACHED", mod.CF_MATE_DOWNSTREAM)


def _patch_rans_order1(m, mod):
    """rANS series blocks that claim order 1 (rc -3 natively)."""
    compress = mod._rans_compress
    m.setattr(mod, "_rans_compress", lambda data: b"\x01" + compress(data)[1:])


def _patch_count_mismatch(m, mod):
    """Container and slice disagree on the record count."""
    orig = mod._slice_blocks

    def bad_slice(flags, counter, method):
        blocks = orig(flags, counter, method)
        head = (mod.itf8_encode(-1) + mod.itf8_encode(0) + mod.itf8_encode(0)
                + mod.itf8_encode(max(flags.size - 1, 0))
                + mod.ltf8_encode(counter) + mod.itf8_encode(4) + mod.itf8_encode(3)
                + b"".join(mod.itf8_encode(c) for c in (1, 2, 3))
                + mod.itf8_encode(-1) + b"\x00" * 16)
        blocks[0] = mod._write_block(mod.RAW, mod.CT_SLICE_HEADER, 0, head)
        return blocks
    m.setattr(mod, "_slice_blocks", bad_slice)


#: each refusal case: (writer patch, block method, the Python walk's words)
REFUSALS = {"series codec": (_patch_series_codec, tcram.RAW, "EXTERNAL"),
            "block method": (_patch_block_method, tcram.RAW, "compression method 2"),
            "mate downstream": (_patch_mate_downstream, tcram.RAW, "mate linking"),
            "rans order-1": (_patch_rans_order1, tcram.RANS, "order-1"),
            "count mismatch": (_patch_count_mismatch, tcram.RAW, "count mismatch")}


def write_refused(path, name: str, mod=tcram) -> None:
    """300 words written by ``mod``'s writer under refusal ``name``'s patch."""
    patch, method, _ = REFUSALS[name]
    with pytest.MonkeyPatch.context() as m:
        patch(m, mod)
        mod.write_cram(path, generate_flags(300, seed=1), method=method)


def _refused(tmp_path, name):
    """Write refusal ``name``'s CRAM with both packages' writers and
    check that every reader refuses it: the Python walk in the JAX
    package's words, the fused walkers and the column reader with the
    same rc."""
    paths = {}
    for label, mod in (("jax", jcram), ("port", tcram)):
        paths[label] = tmp_path / f"{label}.cram"
        write_refused(paths[label], name, mod)
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    p = paths["port"]
    match = REFUSALS[name][2]
    msg = _raise_message(tcram.read_cram_flags_py, p)
    assert match in msg and msg == _raise_message(jcram.read_cram_flags, p)
    _column_refuses_as_the_fused_walker(p)
    with pytest.raises(ValueError, match="lfs_cram_flagstat_range failed"):
        tcram.flagstat_cram_range(p, 0, 1, impl="native")
    return p


def test_unsupported_series_codec(tmp_path):
    _refused(tmp_path, "series codec")


def test_unsupported_block_method(tmp_path):
    _refused(tmp_path, "block method")


def test_mate_downstream_refused(tmp_path):
    """Within-slice mate linking cannot be reconstructed without the
    full record decode: refused."""
    _refused(tmp_path, "mate downstream")


def test_rans_order1_block_refused(tmp_path, monkeypatch):
    p = _refused(tmp_path, "rans order-1")
    assert _raise_message(_fused, p) == \
        "lfs_cram_flagstat failed (rc=-3) — corrupt, truncated, or outside the " \
        "documented CRAM subset"
    monkeypatch.setattr(native_lib, "load_readers", lambda: None)   # the Python decoder too
    with pytest.raises(ValueError, match="order-1"):
        tcram.read_cram_flags(p)
    assert tcram.READ_ROUTE == "python"


def test_record_count_mismatch_caught(tmp_path):
    _refused(tmp_path, "count mismatch")


# ---- hostile inputs never miscount ----

@pytest.mark.parametrize("walker", ["python", "native", "column"])
def test_truncation_never_miscounts(tmp_path, walker):
    """Every prefix of a valid CRAM either errors or, at a container
    boundary, holds exactly the records of its whole containers."""
    x = generate_flags(3_000, seed=3, full_range=True)
    p = tmp_path / "t.cram"
    tcram.write_cram(p, x, records_per_container=1_000)
    blob = p.read_bytes()
    q = tmp_path / "trunc.cram"
    rng = np.random.default_rng(0)
    cuts = sorted(set(rng.integers(1, len(blob), 200).tolist())
                  | {1, 25, 26, 27, len(blob) - 1, len(blob) - 39})
    ok_prefix = 0
    for cut in cuts:
        q.write_bytes(blob[:cut])
        try:
            if walker != "native":
                read = tcram.read_cram_flags_py if walker == "python" else tcram.read_cram_flags
                got = read(q)
                want = x[:got.size]
                assert got.size in (0, 1000, 2000, 3000)
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(got, jcram.read_cram_flags(q))
            else:
                got = _fused(q)
                n = int(got[9] + got[25])
                assert n in (0, 1000, 2000, 3000)
                np.testing.assert_array_equal(got, flagstat_numpy(x[:n]))
        except ValueError:
            continue
        ok_prefix += 1
    assert ok_prefix < len(cuts)   # truncations do get caught


@pytest.mark.parametrize("walker", ["python", "native", "column"])
def test_mutation_never_miscounts(tmp_path, walker):
    """Single-bit flips: every read either raises or returns the exact
    column (a flip inside the ignored 20-byte file id, say)."""
    x = generate_flags(2_000, seed=5, full_range=True)
    ref = flagstat_numpy(x)
    p = tmp_path / "t.cram"
    tcram.write_cram(p, x)
    blob = bytearray(p.read_bytes())
    q = tmp_path / "mut.cram"
    rng = np.random.default_rng({"python": 1, "native": 3, "column": 4}[walker])
    for pos in rng.integers(0, len(blob), 250).tolist():
        mut = bytearray(blob)
        mut[pos] ^= 1 << int(rng.integers(0, 8))
        q.write_bytes(bytes(mut))
        try:
            if walker == "python":
                np.testing.assert_array_equal(tcram.read_cram_flags_py(q), x)
            elif walker == "column":
                np.testing.assert_array_equal(tcram.read_cram_flags(q), x)
            else:
                np.testing.assert_array_equal(_fused(q), ref)
        except (ValueError, OverflowError):
            continue


def test_rans_roundtrip_and_differential():
    rng = np.random.default_rng(0)
    cases = [b"", b"x", b"x" * 9999, rng.integers(0, 256, 40000, dtype=np.uint8).tobytes(),
             rng.integers(0, 3, 80000, dtype=np.uint8).tobytes(), bytes(range(256)) * 64]
    lib = native_lib.load_readers()
    for data in cases:
        comp = tcram._rans_compress(data)
        assert comp == jcram._rans_compress(data)
        src = np.frombuffer(comp, np.uint8)
        assert lib.lfs_rans4x8_size(src.ctypes.data, src.size) == len(data)
        assert tcram._rans_decompress(comp, len(data)) == data
        assert tcram._rans_decompress_py(comp) == data


def test_rans_order1_refused_and_corruption_caught():
    data = b"hello rans" * 50
    comp = bytearray(tcram._rans_compress(data))
    comp[0] = 1                       # claim order-1
    for dec in (lambda b: tcram._rans_decompress(bytes(b), len(data)),
                lambda b: tcram._rans_decompress_py(bytes(b))):
        with pytest.raises(ValueError, match="order-1"):
            dec(comp)
    comp[0] = 0
    rng = np.random.default_rng(2)
    good = bytes(comp)
    for _ in range(150):
        mut = bytearray(good)
        if rng.integers(0, 2):
            mut = mut[:int(rng.integers(1, len(good)))]
        else:
            mut[int(rng.integers(0, len(good)))] ^= 1 << int(rng.integers(0, 8))
        for dec in (lambda b: tcram._rans_decompress(bytes(b), len(data)),
                    lambda b: tcram._rans_decompress_py(bytes(b))):
            try:
                got = dec(mut)
            except ValueError:
                continue
            assert len(got) == len(data)


def test_cram_rans_blocks_python_route(monkeypatch, crams, words):
    monkeypatch.setattr(native_lib, "load_readers", lambda: None)
    np.testing.assert_array_equal(tcram.read_cram_flags(crams["rans"]), words)
    assert tcram.READ_ROUTE == "python"


def _heavy_slice(mod):
    """A slice with a large extra external block (a stand-in for
    sequences and qualities) whose payload is not even valid for its
    declared method: a reader that touched it would raise."""
    orig = mod._slice_blocks

    def heavy_slice(flags, counter, method):
        blocks = orig(flags, counter, method)
        bogus = b"\x00" * 200_000               # not a gzip stream
        body = (bytes([mod.GZIP, mod.CT_EXTERNAL]) + mod.itf8_encode(99)
                + mod.itf8_encode(len(bogus)) + mod.itf8_encode(1 << 20) + bogus)
        blocks.append(body + struct.pack("<I", zlib.crc32(body)))
        return blocks
    return heavy_slice


def test_columnar_io_skips_unneeded_blocks(tmp_path, monkeypatch):
    x = generate_flags(5_000, seed=17, full_range=True)
    paths = {}
    for name, mod in (("jax", jcram), ("port", tcram)):
        with monkeypatch.context() as m:
            m.setattr(mod, "_slice_blocks", _heavy_slice(mod))
            paths[name] = tmp_path / f"{name}.cram"
            mod.write_cram(paths[name], x)
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    p = paths["port"]
    for threads in (0, 1):
        np.testing.assert_array_equal(tcram.read_cram_flags(p, threads=threads), x)
    np.testing.assert_array_equal(_fused(p), flagstat_numpy(x))
    for kw in ({"impl": "native"}, {"device": "cpu"}):
        np.testing.assert_array_equal(tcram.flagstat_cram_range(p, 0, 1, **kw),
                                      flagstat_numpy(x))


# ---- container ranges, the multihost shard unit ----

@pytest.mark.parametrize("kw", [{"impl": "native"}, {"device": "cpu"}])
def test_container_range_counting(crams, words, kw):
    """By the fused range walker and by the card route's plain version."""
    for method in ("gzip", "rans"):
        path = crams[method]
        assert tcram.data_container_count(path) == jcram.data_container_count(path) == 4
        whole = flagstat_numpy(words)
        total = np.zeros(32, np.uint64)
        for a, b in ((0, 1), (1, 3), (3, 4)):
            got = tcram.flagstat_cram_range(path, a, b, threads=2, **kw)
            np.testing.assert_array_equal(got, jcram.flagstat_cram_range(path, a, b))
            total += got
        np.testing.assert_array_equal(total, whole)
        assert (tcram.flagstat_cram_range(path, 4, 4, **kw) == 0).all()
        np.testing.assert_array_equal(tcram.flagstat_cram_range(path, 0, 99, **kw), whole)


@pytest.mark.parametrize("impl,device", [(None, "cpu"), ("numpy", None), ("native", None),
                                         ("torch", None), ("cuda", "cpu"), ("cuda_pre", "cpu"),
                                         ("cuda_words", "cpu")])
def test_flagstat_cram_range_tiers(crams, words, impl, device):
    """flagstat_cram_range is routed as flagstat_cram: the range's
    column in every tier (the kernel impls through their plain versions
    on the CPU) = the JAX range = the oracle of its words."""
    path = crams["rans"]
    before = dict(K.LAUNCHES)
    got = tcram.flagstat_cram_range(path, 1, 3, threads=2, impl=impl, device=device)
    assert K.LAUNCHES == before
    np.testing.assert_array_equal(got, jcram.flagstat_cram_range(path, 1, 3))
    np.testing.assert_array_equal(got, flagstat_numpy(words[40_000:120_000]))


def test_python_route_without_the_readers_is_stated(crams, words, monkeypatch, capsys):
    """With the readers away, the Python walk reads and counts (rANS in
    Python), and says so once per call; the fused walker and the rANS
    writer raise with the build error."""
    ranges = ((0, 2), (2, 4))
    native = [tcram.flagstat_cram_range(crams["gzip"], a, b, impl="native") for a, b in ranges]
    capsys.readouterr()
    monkeypatch.setattr(native_lib, "load_readers", lambda: None)
    monkeypatch.setattr(native_lib, "READERS_BUILD_ERROR", "RuntimeError: g++ failed (test)")
    np.testing.assert_array_equal(tcram.read_cram_flags(crams["rans"]), words)
    assert tcram.READ_ROUTE == "python"
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "read_cram_flags" in err[0] and "g++ failed (test)" in err[0]
    python = [tcram.flagstat_cram_range(crams["gzip"], a, b, device="cpu") for a, b in ranges]
    assert tcram.READ_ROUTE == "python"
    for got, want in zip(python, native):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(python[0] + python[1], flagstat_numpy(words))
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and all("flagstat_cram_range" in line for line in err)
    np.testing.assert_array_equal(tcram.flagstat_cram(crams["gzip"], device="cpu"),
                                  flagstat_numpy(words))
    for call in (lambda: tcram.flagstat_cram(crams["gzip"], impl="native"),
                 lambda: tcram.flagstat_cram_range(crams["gzip"], 0, 1, impl="native")):
        with pytest.raises(RuntimeError, match="readers did not build"):
            call()
    with pytest.raises(RuntimeError, match=r"g\+\+ failed \(test\)"):
        tcram.write_cram(crams["rans"].parent / "x.cram", words[:10], method=tcram.RANS)


def test_no_card_and_no_device_raises_before_reading(crams, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")

    def no_read(*a, **k):
        raise AssertionError("read before the raise")

    monkeypatch.setattr(tcram, "read_cram_flags", no_read)
    monkeypatch.setattr(tcram, "_iter_data_containers", no_read)
    before = dict(K.LAUNCHES)
    for call in (tcram.flagstat_cram, L.flagstat_file):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(crams["gzip"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcram.flagstat_cram_range(crams["gzip"], 0, 1)
    assert K.LAUNCHES == before

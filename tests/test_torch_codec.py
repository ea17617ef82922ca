"""The framed file format is the contract between the packages: a file
the JAX package's codec writes reads in the port, and the other way
round, for raw, LZ4 and Zstd; both reject the same corrupt inputs with
ValueError."""
import struct

import numpy as np
import pytest

from libflagstats_tpu.io import codec as jC
from libflagstats_tpu.oracle import generate_flags
from libflagstats_tpu_torch.io import codec as tC
from libflagstats_tpu_torch.io import native_lib

CODECS = ["raw", "lz4", "zstd"]


@pytest.fixture(scope="module")
def words():
    return generate_flags(700_001, seed=71, full_range=True)


def _read_all(C, path, codec, n_frames):
    """Every reader of one codec module over one file -> uint16 arrays."""
    whole = C.read_framed(path, codec, n_threads=2)
    blocks = np.concatenate(list(C.iter_framed_blocks(path, codec)))
    ranges = [C.read_framed_range(path, codec, a, b)
              for a, b in C.shard_block_ranges(n_frames, 3)]
    return whole, blocks, np.concatenate(ranges)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_read(tmp_path, words, codec, writer):
    path = tmp_path / f"x.{codec}"
    write = (jC if writer == "jax" else tC).write_framed
    info = write(path, words, codec=codec, level=1, block_bytes=200_000)
    assert info.raw_bytes == words.nbytes and info.n_blocks == -(-words.nbytes // 200_000)
    assert tC.scan_frames(path) == jC.scan_frames(path)
    assert list(tC.iter_framed(path)) == list(jC.iter_framed(path))
    for C in (jC, tC):
        for got in _read_all(C, path, codec, info.n_blocks):
            np.testing.assert_array_equal(got, words)


@pytest.mark.parametrize("codec", CODECS)
def test_blocks_cross_decode(codec):
    data = generate_flags(10_000, seed=72).tobytes()
    for src, dst in ((jC, tC), (tC, jC)):
        blob = src.compress_block(data, codec, level=3)
        assert dst.decompress_block(blob, len(data), codec) == data


def _frame(raw_len, payload):
    return struct.pack("<ii", raw_len, len(payload)) + payload


CORRUPT = {
    "truncated header": lambda good: good + b"\x01\x02\x03",
    "odd raw length": lambda good: _frame(3, b"abc"),
    "negative length": lambda good: struct.pack("<ii", -2, 0),
    "truncated payload": lambda good: good[:-5],
}


@pytest.mark.parametrize("case", list(CORRUPT))
def test_corrupt_headers_rejected_alike(tmp_path, case):
    good = _frame(8, np.arange(4, dtype=np.uint16).tobytes())
    path = tmp_path / "bad.bin"
    path.write_bytes(CORRUPT[case](good))
    for C in (jC, tC):
        with pytest.raises(ValueError):
            list(C.iter_framed(path))
        with pytest.raises(ValueError):
            C.scan_frames(path)


def test_trailing_garbage_rejected_alike(tmp_path):
    path = tmp_path / "tail.bin"
    path.write_bytes(_frame(8, np.arange(4, dtype=np.uint16).tobytes()) + b"\x00" * 5)
    for C in (jC, tC):
        with pytest.raises(ValueError, match="trailing garbage"):
            C.scan_frames(path)
        with pytest.raises(ValueError, match="trailing garbage"):
            C.read_framed(path, "raw")


def test_short_raw_block_rejected_alike():
    for C in (jC, tC):
        with pytest.raises(ValueError, match="corrupt raw block"):
            C.decompress_block(b"abc", 4, "raw")


def test_pure_python_lz4_equals_native():
    """The fallbacks kept from the JAX codec: the pure-Python LZ4 decoder
    reads what the native encoder writes, in both packages."""
    assert native_lib.load() is not None, native_lib.BUILD_ERROR
    data = generate_flags(50_000, seed=73).tobytes()
    blob = tC.compress_block(data, "lz4", level=1)
    assert tC._lz4_decompress_py(blob, len(data)) == data
    assert jC._lz4_decompress_py(blob, len(data)) == data
    lit = tC._lz4_compress_py(data)
    assert lit == jC._lz4_compress_py(data)
    assert tC.decompress_block(lit, len(data), "lz4") == data


def test_names_and_ranges_equal():
    for codec, level in (("lz4", 9), ("lz4", 1), ("lz4", -9), ("zstd", 3), ("raw", 0)):
        assert tC.codec_filename("in", codec, level) == jC.codec_filename("in", codec, level)
    for n, k in ((10, 3), (2, 4), (0, 1)):
        assert tC.shard_block_ranges(n, k) == jC.shard_block_ranges(n, k)
    assert tC.BLOCK_BYTES == jC.BLOCK_BYTES

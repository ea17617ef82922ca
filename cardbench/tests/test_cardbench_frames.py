"""The frame writer: upstream's framed layout, decoded back by the
system LZ4 library."""
import os
import struct

import numpy as np
import pytest

from cardbench import frames


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("n_words", [1, 511, 512, 5000])
def test_frames_decode_back_to_the_column(level, n_words):
    rng = np.random.default_rng(n_words)
    words = rng.integers(0, 1 << 12, size=n_words, dtype=np.uint16)
    spec = {"codec": "lz4", "level": level, "block_bytes": 1024}
    f, path = frames.temp_file()
    with f:
        info = frames.write_frames(words, spec, f.fileno(), threads=3)
        assert info["frames"] == -(-words.nbytes // 1024)
        assert info["file_bytes"] == os.fstat(f.fileno()).st_size
        assert np.array_equal(frames.read_frames(path, spec), words)
        with open(path, "rb") as g:
            raw_len, comp_len = struct.unpack("<ii", g.read(8))
        assert raw_len == min(1024, words.nbytes) and comp_len > 0


def test_temp_file_leaves_no_name(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    f, path = frames.temp_file()
    with f:
        f.write(b"x")
        assert os.path.exists(path)
        assert list(tmp_path.iterdir()) == []
    assert not os.path.exists(path)


def test_unknown_codec_raises():
    with pytest.raises(KeyError):
        frames.codec({"codec": "zstd", "level": 1})

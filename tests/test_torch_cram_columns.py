"""The container column reader (io/csrc/cram_columns.cpp, bound by
io/native_lib.py ``load_columns()``) behind ``cramio.read_cram_flags``,
against the JAX package's ``read_cram_flags`` on the same seeded files,
tolerance 0: RAW, GZIP and rANS files at 2^20, 7,000 and 1,000 records a
container, the edge sizes either side of a container boundary, every
record detached (the writer's layout, so the mate bits 0x20 / 0x8 come
back from the MF series), container ranges over P = 1..5 at 1, 2 and 4
threads concatenating to the file's column, the sizing call's exact
count, the refused cap, and the view-or-copy rule of the readers'
bound-sized buffers."""
import ctypes

import numpy as np
import pytest

from libflagstats_tpu.io import cramio as jcram
from libflagstats_tpu.oracle import generate_flags
from libflagstats_tpu_torch.io import cramio as tcram
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.io.codec import shard_block_ranges

METHODS = {"raw": tcram.RAW, "gzip": tcram.GZIP, "rans": tcram.RANS}


@pytest.fixture(scope="module")
def words():
    return generate_flags(30_001, seed=131, full_range=True)


@pytest.fixture(scope="module")
def crams(tmp_path_factory, words):
    """The column at 4,000 records a container (8 containers), one file
    per method, written by the JAX package."""
    d = tmp_path_factory.mktemp("cram_columns")
    files = {}
    for name, method in METHODS.items():
        files[name] = d / f"{name}.cram"
        jcram.write_cram(files[name], words, records_per_container=4_000, method=method)
    return files


def _sizing(path):
    """(records, containers) of the sizing call over the whole file."""
    lib = native_lib.columns()
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    n_containers = ctypes.c_int64(-1)
    n = lib.lfs_cram_range_records(mm.ctypes.data, mm.size, 0, -1, ctypes.byref(n_containers))
    return n, n_containers.value


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("rpc", [1 << 20, 7_000, 1_000])
def test_column_reader_equals_jax(tmp_path, words, method, rpc):
    p = tmp_path / "c.cram"
    jcram.write_cram(p, words, records_per_container=rpc, method=METHODS[method])
    want = jcram.read_cram_flags(p)
    np.testing.assert_array_equal(want, words)
    for threads in (0, 1, 3):
        got = tcram.read_cram_flags(p, threads=threads)
        assert tcram.READ_ROUTE == "native" and got.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
    # the writer strips 0x20 / 0x8 from BF and carries them in MF for
    # every (detached) record: the column holds them only through the rebuild
    assert (words & 0x20).any() and (words & 0x8).any()
    assert _sizing(p) == (words.size, jcram.data_container_count(p))


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 4096, 4097])
def test_edge_sizes_equal_jax(tmp_path, n):
    """Empty, one word, and one word either side of a container boundary
    (1,024 records a container)."""
    x = generate_flags(n, seed=n + 7, full_range=True)
    p = tmp_path / "e.cram"
    jcram.write_cram(p, x, records_per_container=1024)
    got = tcram.read_cram_flags(p, threads=2)
    assert tcram.READ_ROUTE == "native"
    np.testing.assert_array_equal(got, jcram.read_cram_flags(p))
    np.testing.assert_array_equal(got, x)
    assert _sizing(p) == (n, -(-n // 1024))


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_container_ranges_concatenate_to_the_column(crams, words, threads):
    """Ranges that tile the containers give the Python walk's range
    columns, which concatenate to the file's column; an empty range
    gives none."""
    for path in crams.values():
        n = tcram.data_container_count(path)
        assert n == 8
        for parts in range(1, 6):
            cols = []
            for a, b in shard_block_ranges(n, parts):
                col = tcram._read_range(path, a, b, threads, "test")
                assert tcram.READ_ROUTE == "native"
                np.testing.assert_array_equal(col, tcram._read_range_py(path, a, b, threads))
                cols.append(col)
            np.testing.assert_array_equal(np.concatenate(cols), words)
        for a in (0, 5, n, n + 3):
            assert tcram._read_range(path, a, a, threads, "test").size == 0
        np.testing.assert_array_equal(tcram._read_range(path, 6, 99, threads, "test"),
                                      words[24_000:])


def test_a_cap_below_the_column_is_refused(crams, words):
    lib = native_lib.columns()
    mm = np.memmap(crams["gzip"], dtype=np.uint8, mode="r")
    out = np.zeros(words.size, np.uint16)
    n_out = ctypes.c_int64(-1)
    for cap in (0, words.size - 1):
        rc = lib.lfs_cram_flags_range(mm.ctypes.data, mm.size, 0, -1, out.ctypes.data, cap, 2,
                                      ctypes.byref(n_out))
        assert rc == -5 and n_out.value == -1 and not out.any()
    assert lib.lfs_cram_flags_range(mm.ctypes.data, mm.size, 0, -1, out.ctypes.data, words.size,
                                    2, ctypes.byref(n_out)) == 0
    assert n_out.value == words.size
    np.testing.assert_array_equal(out, words)
    # an inverted range is refused as the fused range walker refuses it
    assert lib.lfs_cram_range_records(mm.ctypes.data, mm.size, 3, 2, None) == -2


@pytest.mark.parametrize("got,copied", [(100, False), (25, False), (24, True), (0, True)])
def test_a_bound_sized_buffer_is_viewed_or_copied(got, copied):
    """A reader's buffer comes back as a view of its column while it is
    at most COLUMN_SLACK times the column, else as a copy."""
    out = np.arange(100, dtype=np.uint16)
    assert native_lib.COLUMN_SLACK == 4
    col = native_lib.column(out, got)
    np.testing.assert_array_equal(col, out[:got])
    assert np.shares_memory(col, out) == (not copied and got > 0)

"""The port's copies of the host C++ sources equal the JAX package's byte
for byte, the loader compiles only sources under the port (the port's
own flag_columns.cpp reaches the readers through the copies only), and
the package data ships the copies and their headers. Reads files only;
imports nothing of either package."""
import re
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
ORIGINAL = REPO / "libflagstats_tpu" / "io" / "native"
COPY = REPO / "libflagstats_tpu_torch" / "io" / "csrc"


@pytest.mark.parametrize("name", ["flagstats_io.cpp", "flagstats_host.cpp", "bam_reader.cpp",
                                  "sam_reader.cpp", "rans4x8.cpp", "cram_reader.cpp", "bgzf.h",
                                  "perf_events.cpp"])
def test_host_source_copy_is_byte_identical(name):
    copy = (COPY / name).read_bytes()
    assert copy == (ORIGINAL / name).read_bytes()
    # a local include would pull a header the port does not carry: the
    # only one is bgzf.h, copied too
    assert re.findall(rb'#include "([^"]*)"', copy) in ([], [b"bgzf.h"])


def test_loader_builds_only_the_ports_sources():
    text = (REPO / "libflagstats_tpu_torch" / "io" / "native_lib.py").read_text()
    assert 'SOURCES = (CSRC / "flagstats_io.cpp", CSRC / "flagstats_host.cpp")' in text
    assert ('READER_SOURCES = (CSRC / "bam_reader.cpp", CSRC / "sam_reader.cpp", '
            'CSRC / "rans4x8.cpp",\n                  CSRC / "cram_reader.cpp", '
            'CSRC / "flagstats_host.cpp")') in text
    assert 'READER_HEADERS = (CSRC / "bgzf.h",)' in text
    assert 'PERF_SOURCES = (CSRC / "perf_events.cpp",)' in text
    assert 'COLUMNS_SOURCES = (CSRC / "flag_columns.cpp", CSRC / "flagstats_host.cpp")' in text
    assert ('COLUMNS_HEADERS = (CSRC / "bam_reader.cpp", CSRC / "sam_reader.cpp", '
            'CSRC / "bgzf.h")') in text
    assert '"libflagstats_tpu"' not in text


def test_columns_source_reaches_the_readers_only_through_the_copies():
    """The port's own flag_columns.cpp includes the two reader copies
    (whose internal range machinery it needs) and nothing else local;
    it is not a copy, so the JAX package has no such file."""
    src = (COPY / "flag_columns.cpp").read_bytes()
    assert re.findall(rb'#include "([^"]*)"', src) == [b"bam_reader.cpp", b"sam_reader.cpp"]
    assert not (ORIGINAL / "flag_columns.cpp").exists()


def test_package_data_ships_the_copies():
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    for pattern in ("csrc/*.cpp", "csrc/*.h", "csrc/compat/*.h"):
        assert pattern in data["libflagstats_tpu_torch.io"]
    assert "csrc/*.cu" in data["libflagstats_tpu_torch.ops"]

"""The port's copies of the host C++ sources equal the JAX package's byte
for byte, the loader compiles only sources under the port, and the
package data ships the copies and their headers. Reads files only;
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
    assert '"libflagstats_tpu"' not in text


def test_package_data_ships_the_copies():
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    for pattern in ("csrc/*.cpp", "csrc/*.h", "csrc/compat/*.h"):
        assert pattern in data["libflagstats_tpu_torch.io"]
    assert "csrc/*.cu" in data["libflagstats_tpu_torch.ops"]

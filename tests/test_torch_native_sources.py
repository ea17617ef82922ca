"""The port's copies of the host C++ sources equal the JAX package's byte
for byte, the loader compiles only sources under the port, and the
package data ships the copies. Reads files only; imports nothing of
either package."""
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
ORIGINAL = REPO / "libflagstats_tpu" / "io" / "native"
COPY = REPO / "libflagstats_tpu_torch" / "io" / "csrc"


@pytest.mark.parametrize("name", ["flagstats_io.cpp", "flagstats_host.cpp"])
def test_host_source_copy_is_byte_identical(name):
    copy = (COPY / name).read_bytes()
    assert copy == (ORIGINAL / name).read_bytes()
    # a local include would pull a header the port does not carry
    assert b'#include "' not in copy


def test_loader_builds_only_the_ports_sources():
    text = (REPO / "libflagstats_tpu_torch" / "io" / "native_lib.py").read_text()
    assert 'SOURCES = (CSRC / "flagstats_io.cpp", CSRC / "flagstats_host.cpp")' in text
    assert '"libflagstats_tpu"' not in text


def test_package_data_ships_the_copies():
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert "csrc/*.cpp" in data["libflagstats_tpu_torch.io"]
    assert "csrc/*.cu" in data["libflagstats_tpu_torch.ops"]

"""chip_smoke.py on the CPU: ``--phases`` takes a comma list of phase
names (default: every phase, the card check's full run), keeps the run
order and refuses a name that is no phase; its fast oracle equals
flagstat_numpy; phase 4m's parse of multihost_scaling's lines matches
what the tool prints. Without a card the script raises before it builds
or counts anything."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.tools import multihost_scaling

SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(chip_smoke)


def test_every_phase_by_default():
    assert "4k" in chip_smoke.PHASES      # the container path
    assert "4l" in chip_smoke.PHASES      # CRAM, the container legs and na12878_run
    assert "4m" in chip_smoke.PHASES      # the last tools, perf_native, the entry points
    assert "4o" in chip_smoke.PHASES      # the epilogue kernel
    assert chip_smoke.parse_phases([]) == list(chip_smoke.PHASES)
    assert "4s" in chip_smoke.SHAKEDOWNS and "4s" not in chip_smoke.PHASES   # only when named
    assert chip_smoke.parse_phases(["--phases", ",".join(chip_smoke.PHASES)]) == \
        list(chip_smoke.PHASES)


@pytest.mark.parametrize("arg,want", [("3c,5c", ["3c", "5c"]), ("5c,3c", ["3c", "5c"]),
                                      (" 4i , 3 ", ["3", "4i"]), ("5c,5c", ["5c"]),
                                      ("4k", ["4k"]), ("5,4k,4j", ["4j", "4k", "5"]),
                                      ("4l", ["4l"]), ("4l,4k", ["4k", "4l"]),
                                      ("4m", ["4m"]), ("5,4m,4l", ["4l", "4m", "5"]),
                                      ("4s", ["4s"]), ("4s,5,4a", ["4a", "5", "4s"])])
def test_chosen_phases_run_in_order(arg, want):
    assert chip_smoke.parse_phases(["--phases", arg]) == want


@pytest.mark.parametrize("arg", ["3c,9z", "", ",", "3C", "4a-d", "all"])
def test_unknown_phases_are_refused(arg, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.parse_phases(["--phases", arg])
    assert e.value.code == 2
    assert "choose from 3,3b,3c" in capsys.readouterr().err


def test_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        chip_smoke.main(["--phases", "3c"])


@pytest.mark.parametrize("kind", ["full-range", "flags<4096", "0x0FFF", "0x0DFF", "zero",
                                  "one odd word", "short"])
def test_oracle_counts_equals_flagstat_numpy(kind, monkeypatch):
    """The threaded oracle and its repeated-word shortcut are exact."""
    monkeypatch.setattr(chip_smoke, "ORACLE_PIECE", 1 << 14)
    n = (1 << 14) * 3 + 4321
    x = {"full-range": lambda: generate_flags(n, seed=5, full_range=True),
         "flags<4096": lambda: generate_flags(n, seed=6),
         "0x0FFF": lambda: np.full(n, 0x0FFF, np.uint16),
         "0x0DFF": lambda: np.full(n, 0x0DFF, np.uint16),
         "zero": lambda: np.zeros(n, np.uint16),
         "one odd word": lambda: np.concatenate([np.full(n - 1, 99, np.uint16),
                                                 np.full(1, 0x0FFF, np.uint16)]),
         "short": lambda: generate_flags(1000, seed=7, full_range=True)}[kind]()
    got = chip_smoke.oracle_counts(x)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    np.testing.assert_array_equal(chip_smoke.oracle_counts(x[:0]), np.zeros(32, np.uint64))


def test_phase_4m_reads_multihost_scalings_lines(monkeypatch, tmp_path, capsys):
    path = tmp_path / "f"
    path.write_bytes(b"x")
    monkeypatch.setattr(multihost_scaling, "run_worlds",
                        lambda nproc, files, threads, iters: {kind: {
                            "nproc": nproc, "threads": threads, "wall_s": 0.5,
                            "records": 1234567, "words_per_s": 1234567 / 0.5} for kind in files})
    multihost_scaling.run({"framed": str(path)}, iters=1)
    lines = capsys.readouterr().out.splitlines()
    got = [m.groups() for m in map(chip_smoke.SCALING_LINE.match, lines) if m]
    assert got == [("framed", str(p), str(t), "1234567") for p, t, _ in multihost_scaling.WORLDS]

"""chip_smoke.py's phase selector on the CPU: ``--phases`` takes a comma
list of phase names (default: every phase, the card check's full run),
keeps the run order and refuses a name that is no phase. Without a card
the script raises before it builds or counts anything."""
import importlib.util
from pathlib import Path

import pytest
import torch

SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(chip_smoke)


def test_every_phase_by_default():
    assert "4k" in chip_smoke.PHASES      # the container path
    assert "4l" in chip_smoke.PHASES      # CRAM, the container legs and na12878_run
    assert chip_smoke.parse_phases([]) == list(chip_smoke.PHASES)
    assert chip_smoke.parse_phases(["--phases", ",".join(chip_smoke.PHASES)]) == \
        list(chip_smoke.PHASES)


@pytest.mark.parametrize("arg,want", [("3c,5c", ["3c", "5c"]), ("5c,3c", ["3c", "5c"]),
                                      (" 4i , 3 ", ["3", "4i"]), ("5c,5c", ["5c"]),
                                      ("4k", ["4k"]), ("5,4k,4j", ["4j", "4k", "5"]),
                                      ("4l", ["4l"]), ("4l,4k", ["4k", "4l"])])
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

"""The port's dispatch-crossover calibration (calibration.py,
ops/dispatch.py ``_apply_calibration``, ``tools/crossover_sweep --device
cpu --write``), case for case with tests/test_calibration.py on the
port's names (``TORCH_MIN_CPU``, ``POSPOPCNT_TORCH_MIN_CPU``), its
variable ``LFS_TORCH_CALIBRATION_FILE`` and temporary paths; and what
the port adds: the repository root's ``calibration.json`` (the JAX
package's) is never read or written, a written ``TORCH_MIN_CPU`` moves
``auto_impl(n, "cpu")`` while a call on the card reads no threshold, and
the paths that need a device tier keep it whatever the file says."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from libflagstats_tpu_torch import calibration
from libflagstats_tpu_torch.ops import dispatch
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.tools import crossover_sweep

ROOT_FILE = Path(__file__).resolve().parent.parent / "calibration.json"


@pytest.fixture
def cal_file(tmp_path, monkeypatch):
    path = tmp_path / "calibration.json"
    monkeypatch.setenv("LFS_TORCH_CALIBRATION_FILE", str(path))
    yield path
    # the built-in defaults for the rest of the suite
    monkeypatch.delenv("LFS_TORCH_CALIBRATION_FILE")
    dispatch.TORCH_MIN_CPU = 0
    dispatch.POSPOPCNT_TORCH_MIN_CPU = 0


def test_write_load_roundtrip(cal_file):
    calibration.write_thresholds(
        {"TORCH_MIN_CPU": 1 << 13, "POSPOPCNT_TORCH_MIN_CPU": 1 << 20},
        {"date": "2026-10-17", "backend": "cpu", "card": "x", "dispatch_rtt_ms": 0.3,
         "tool": "crossover_sweep"})
    got = calibration.load_thresholds()
    assert got == {"TORCH_MIN_CPU": 1 << 13, "POSPOPCNT_TORCH_MIN_CPU": 1 << 20}
    blob = json.loads(cal_file.read_text())   # provenance rides along in the file
    assert blob["version"] == 1
    assert blob["thresholds"]["TORCH_MIN_CPU"]["backend"] == "cpu"
    assert blob["thresholds"]["TORCH_MIN_CPU"]["dispatch_rtt_ms"] == 0.3


def test_write_merges_across_sweeps(cal_file):
    """The flagstat and pospopcnt sweeps accumulate into one file."""
    calibration.write_thresholds({"TORCH_MIN_CPU": 1 << 13}, {"tool": "crossover_sweep"})
    calibration.write_thresholds({"POSPOPCNT_TORCH_MIN_CPU": 1 << 22},
                                 {"tool": "crossover_sweep"})
    assert calibration.load_thresholds() == {"TORCH_MIN_CPU": 1 << 13,
                                             "POSPOPCNT_TORCH_MIN_CPU": 1 << 22}
    assert not Path(str(cal_file) + ".tmp").exists()   # written through a rename


def test_dispatch_applies_calibration(cal_file):
    calibration.write_thresholds({"TORCH_MIN_CPU": 1 << 10, "POSPOPCNT_TORCH_MIN_CPU": 1 << 4},
                                 {"tool": "test"})
    applied = dispatch._apply_calibration()
    assert sorted(applied) == ["POSPOPCNT_TORCH_MIN_CPU", "TORCH_MIN_CPU"]
    assert dispatch.TORCH_MIN_CPU == 1 << 10
    assert dispatch.POSPOPCNT_TORCH_MIN_CPU == 1 << 4


def test_dispatch_auto_impl_moves_with_calibration(cal_file, monkeypatch):
    """The CPU tier follows the file: numpy below TORCH_MIN_CPU, torch
    from it; a call on the card reads no threshold."""
    assert dispatch.auto_impl(1, "cpu") == "torch"   # no file: torch at every size
    assert dispatch.pospopcnt_auto_impl(1, "cpu") == "torch"
    calibration.write_thresholds({"TORCH_MIN_CPU": 1 << 4, "POSPOPCNT_TORCH_MIN_CPU": 1 << 6},
                                 {"tool": "test"})
    dispatch._apply_calibration()
    assert dispatch.auto_impl(1 << 3, "cpu") == "numpy"
    assert dispatch.auto_impl(1 << 4, "cpu") == "torch"      # the calibrated crossover
    assert dispatch.pospopcnt_auto_impl(1 << 5, "cpu") == "numpy"
    assert dispatch.pospopcnt_auto_impl(1 << 6, "cpu") == "torch"
    assert dispatch.auto_impl(1 << 3, "cuda") == "cuda"      # the card: no threshold
    assert dispatch.pospopcnt_auto_impl(1 << 3, "cuda:0") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert dispatch.auto_impl(1 << 3) == "cuda"
    # and the counts follow: numpy below, torch from it, both exact
    for n in (8, 64):
        x = generate_flags(n, seed=n, full_range=True)
        np.testing.assert_array_equal(dispatch.flagstats_u16(x, device="cpu"), flagstat_numpy(x))


def test_malformed_file_warns_and_falls_back(cal_file, capsys):
    cal_file.write_text("{not json")
    assert calibration.load_thresholds() == {}
    assert "unusable" in capsys.readouterr().err
    cal_file.write_text(json.dumps(
        {"version": 1, "thresholds": {"TORCH_MIN_CPU": {"value": "big"}}}))
    assert calibration.load_thresholds() == {}


def test_unknown_names_ignored_on_load_rejected_on_write(cal_file):
    cal_file.write_text(json.dumps(
        {"version": 1, "thresholds": {"XLA_MIN_CPU": {"value": 7},   # the JAX package's name
                                      "TORCH_MIN_CPU": {"value": 64}}}))
    assert calibration.load_thresholds() == {"TORCH_MIN_CPU": 64}
    with pytest.raises(ValueError, match="unknown threshold"):
        calibration.write_thresholds({"DEVICE_MIN_TPU": 1}, {})


def test_env_empty_disables(monkeypatch):
    monkeypatch.setenv("LFS_TORCH_CALIBRATION_FILE", "")
    assert calibration.calibration_path() is None
    assert calibration.load_thresholds() == {}
    with pytest.raises(ValueError, match="disabled"):
        calibration.write_thresholds({"TORCH_MIN_CPU": 1}, {})


def test_sweep_writer_maps_suggestions_to_thresholds(cal_file, monkeypatch):
    """The sweep side: a measured crossover -> its named threshold with
    provenance (the card as nvidia-smi names it), None dropped, all-None
    -> no write; no win at the largest size -> the disabled sentinel."""
    monkeypatch.setattr(crossover_sweep, "card", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    crossover_sweep._write_calibration({"TORCH_MIN_CPU": 1 << 14,
                                        "POSPOPCNT_TORCH_MIN_CPU": None}, "cpu", rtt_ms=0.25)
    assert calibration.load_thresholds() == {"TORCH_MIN_CPU": 1 << 14}
    ent = json.loads(cal_file.read_text())["thresholds"]["TORCH_MIN_CPU"]
    assert ent["dispatch_rtt_ms"] == 0.25 and ent["tool"] == "crossover_sweep"
    assert ent["card"] == "NVIDIA H100 80GB HBM3, 700.00 W" and ent["backend"] == "cpu"
    before = cal_file.read_text()
    crossover_sweep._write_calibration({"TORCH_MIN_CPU": None}, "cpu", rtt_ms=None)
    assert cal_file.read_text() == before
    # rows: (words, numpy_s, native_s, torch_wall_s, torch_kern_s, cuda_wall_s, cuda_kern_s)
    nan = float("nan")
    # torch wins at 1, loses at 2, wins from 4 on: the crossover is 4
    wins_from_4 = [(1, 1.0, 1, 0.5, 0.1, nan, nan), (2, 1.0, 1, 2.0, 1.0, nan, nan),
                   (4, 3.0, 1, 2.0, 1.0, nan, nan), (8, 9.0, 1, 2.0, 1.0, nan, nan)]
    assert crossover_sweep.torch_min(wins_from_4) == 4
    crossover_sweep.write(wins_from_4, pospopcnt=True)
    assert calibration.load_thresholds()["POSPOPCNT_TORCH_MIN_CPU"] == 4
    never = [(1, 1.0, 1, 2.0, 1.0, nan, nan), (2, 1.0, 1, 0.5, 0.1, nan, nan),
             (4, 1.0, 1, 2.0, 1.0, nan, nan)]
    assert crossover_sweep.torch_min(never) is None
    crossover_sweep.write(never, pospopcnt=False)
    assert calibration.load_thresholds()["TORCH_MIN_CPU"] == crossover_sweep.DISABLED == 1 << 62


def test_sweep_rtt_median():
    rows = [(1, 0, 0, 0.050, 0.001), (2, 0, 0, 0.060, 0.002), (3, 0, 0, float("nan"), 0.001)]
    assert crossover_sweep._rtt_ms(rows, 3, 4) == pytest.approx(58.0)


def test_malformed_shapes_never_crash_import(cal_file, capsys):
    """A thresholds value of the wrong shape falls back with a warning:
    the file is read when ops.dispatch is imported."""
    for blob in ('{"version": 1, "thresholds": [1, 2]}',
                 '{"version": 1, "thresholds": "TORCH_MIN_CPU"}',
                 '[1, 2, 3]', '"just a string"', "3"):
        cal_file.write_text(blob)
        assert calibration.load_thresholds() == {}, blob
        assert dispatch._apply_calibration() == []
    assert "unusable" in capsys.readouterr().err


def test_the_root_calibration_json_is_never_touched(monkeypatch, tmp_path):
    """The port's loader and writer default to the user's config path:
    a write with no variable set leaves the repository root's
    calibration.json (the JAX package's entries) byte for byte and
    mtime as it was."""
    monkeypatch.delenv("LFS_TORCH_CALIBRATION_FILE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    before = (ROOT_FILE.read_bytes(), os.stat(ROOT_FILE).st_mtime_ns) \
        if ROOT_FILE.exists() else None
    path = calibration.calibration_path()
    assert path == tmp_path / ".config" / "libflagstats-tpu-torch" / "calibration.json"
    assert calibration.load_thresholds() == {}
    assert calibration.write_thresholds({"TORCH_MIN_CPU": 5}, {"tool": "test"}) == path
    assert calibration.load_thresholds() == {"TORCH_MIN_CPU": 5}
    after = (ROOT_FILE.read_bytes(), os.stat(ROOT_FILE).st_mtime_ns) \
        if ROOT_FILE.exists() else None
    assert after == before


def test_sweep_write_on_the_cpu_writes_the_ports_file(cal_file, monkeypatch, capsys):
    """``crossover_sweep --device cpu --write`` end to end at two small
    sizes, with one repetition each: one threshold written, with the
    card's provenance; ``--write`` without ``--device cpu`` is refused."""
    for name, value in (("FIT_ITERS", 1), ("FIT_ATTEMPTS", 1), ("WALL_ITERS", 1)):
        monkeypatch.setattr(crossover_sweep, name, value)
    monkeypatch.setattr(crossover_sweep, "_ks", lambda n: (1, 2, 3))
    monkeypatch.setattr(crossover_sweep, "card", lambda: "none")
    assert crossover_sweep.main(["1024", "4096", "--device", "cpu", "--write"]) == 0
    assert "# wrote ['TORCH_MIN_CPU']" in capsys.readouterr().out
    ent = json.loads(cal_file.read_text())["thresholds"]["TORCH_MIN_CPU"]
    assert ent["value"] in (1024, 4096, crossover_sweep.DISABLED) and ent["card"] == "none"
    with pytest.raises(SystemExit) as exc:
        crossover_sweep.main(["1024", "--write"])
    assert exc.value.code == 2


def test_device_tiers_keep_their_tier_whatever_the_file_says(cal_file, tmp_path):
    """The paths that need a device tier (sharded, multihost, the
    stream, set algebra) read no threshold: a huge TORCH_MIN_CPU leaves
    them on the torch tier, exact."""
    import libflagstats_tpu_torch as L
    from libflagstats_tpu_torch.io import codec as C
    from libflagstats_tpu_torch.parallel import multihost as M

    calibration.write_thresholds({"TORCH_MIN_CPU": 1 << 40}, {"tool": "test"})
    dispatch._apply_calibration()
    x = generate_flags(50_001, seed=3, full_range=True)
    want = flagstat_numpy(x)
    assert dispatch.auto_impl(x.size, "cpu") == "numpy"
    assert dispatch.device_impl("cpu") == "torch"
    np.testing.assert_array_equal(L.flagstat_sharded(x, devices=["cpu", "cpu"]), want)
    np.testing.assert_array_equal(M.flagstat_multihost(x, device="cpu"), want)
    path = tmp_path / "x.lz4"
    C.write_framed(path, x, "lz4")
    np.testing.assert_array_equal(L.flagstat_stream(path, "lz4", device="cpu"), want)
    bits = np.arange(1000, dtype=np.uint32)
    assert L.popcnt(bits, device="cpu") == sum(bin(int(v)).count("1") for v in bits)

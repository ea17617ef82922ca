"""CPU rehearsals of whole runs: the result line, the checks, the faults
that have to read not correct, the guards of the command line."""
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import libflagstats_tpu_torch as lft
from cardbench import frames, run, spec

ROOT = Path(spec.ROOT)
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
DIVISOR = 256          # 3,220,866 words: 7 blocks of 512,000, 7 frames
SEED = 2**31 + 99


def rehearse(workload, trace=False, seconds=0.3):
    return run.run(workload, SEED, seconds, trace, device="cpu", scale_divisor=DIVISOR,
                   log=io.StringIO())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_is_correct_with_the_contract_keys(workload, trace):
    out = rehearse(workload, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown", "checks"] if trace else ["checks"])
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"] == {"reports_failed": {"value": 0, "limit": 0},
                             "counter_gap_max": {"value": 0, "limit": 0}}
    bench = spec.benchmark()
    if trace:
        named = {m["name"] for m in spec.metrics(bench, "per_layer", workload)}
        assert set(out["metrics"]) <= named
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        named = [m["name"] for m in spec.metrics(bench, "end_to_end", workload)]
        assert list(out["metrics"]) == named
        assert all(out["metrics"][n]["value"] > 0 for n in named)
    assert json.loads(json.dumps(out)) == out


def _unchanged(orig):
    def fn(array, out=None, **kw):
        return out if out is not None else np.zeros(32, dtype=np.uint64)
    return fn


def _half(orig):
    def fn(array, out=None, **kw):
        return orig(array[: len(array) // 2], out=out, **kw)
    return fn


def _altered(orig):
    def fn(*a, **kw):
        r = orig(*a, **kw)
        r[12] += 1
        return r
    return fn


def _stream_half(orig):
    def fn(path, codec, **kw):
        cfg = spec.cell(spec.benchmark(), "lz4-stream")[1]
        words = frames.read_frames(path, cfg["frames"])
        return lft.flagstats_u16(words[: len(words) // 2], device="cpu")
    return fn


FAULTS = {
    "state_unchanged": (_unchanged, lambda orig: lambda *a, **kw: np.zeros(32, np.uint64)),
    "half_left_out": (_half, _stream_half),
    "answer_altered": (_altered, _altered),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_program_reads_not_correct(workload, fault, monkeypatch):
    name = "flagstat_stream" if workload == "lz4-stream" else "flagstats_u16"
    make = FAULTS[fault][name == "flagstat_stream"]
    monkeypatch.setattr(lft, name, make(getattr(lft, name)))
    out = rehearse(workload)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1
    assert out["checks"]["counter_gap_max"]["value"] > 0


def test_a_report_that_raises_in_the_window_is_failed(monkeypatch):
    orig, calls = lft.flagstats_u16, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == run.WARM_REPORTS + 2:
            raise RuntimeError("lost")
        return orig(*a, **kw)
    monkeypatch.setattr(lft, "flagstats_u16", flaky)
    out = rehearse("column-device")
    assert out["correct"] is False and out["failed"] == 1
    assert out["checks"]["counter_gap_max"]["value"] == 0


def test_a_program_that_raises_in_set_up_ends_the_run(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("lost")
    monkeypatch.setattr(lft, "flagstats_u16", boom)
    with pytest.raises(RuntimeError):
        rehearse("column-device")


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_correct_at_a_small_size(workload):
    # float32 is exact below 2**24 words a value: the control fails only
    # at the cells' own size, on the card (test_cardbench_card.py)
    out = run.run(workload, SEED, 0.2, False, device="cpu", scale_divisor=DIVISOR,
                  control=True, log=io.StringIO())
    assert out["correct"] is True


def test_main_without_a_card_exits_nonzero_and_prints_nothing(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "column-device", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_main_refuses_a_run_that_loaded_jax(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run", lambda *a, **kw: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    rc = run.main(["--workload", "column-device", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert "libflagstats_tpu_torch" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    monkeypatch.setitem(sys.modules, "libflagstats_tpu_torchx.y", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "libflagstats_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert run.forbidden_modules() == ["flax", "libflagstats_tpu"]


def test_a_rehearsal_of_every_cell_loads_no_jax():
    code = ("import os, sys\n"
            "from cardbench import run\n"
            f"for w in {CELLS!r}:\n"
            f"    assert run.run(w, 3, 0.2, False, device='cpu', scale_divisor=4096,\n"
            "                   log=open(os.devnull, 'w'))['correct']\n"
            "print(run.forbidden_modules(), 'libflagstats_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "cardbench.run", "--workload", "column-device",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""

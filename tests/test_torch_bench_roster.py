"""The port's measurement path on the CPU: the `kernels` roster, the
`instrumented` and `inmemory` subcommands, the stage decomposition and
the scaling sweep, each with device="cpu" (the only way to time on the
CPU), and the no-card behaviour of the command line."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libflagstats_tpu_torch import cli
from libflagstats_tpu_torch.bench import instrumented, kernels, refcache
from libflagstats_tpu_torch.oracle import flagstat_numpy
from libflagstats_tpu_torch.parallel import multihost
from libflagstats_tpu_torch.tools import stage_decomposition as SD

REPO = Path(__file__).resolve().parent.parent


def _body_rows(lines):
    return [ln for ln in lines[1:] if not ln.startswith("[roofline")]


def test_roster_on_the_cpu(tmp_path):
    lines = kernels.run(n_words=1 << 14, iters=1, cache_dir=str(tmp_path), device="cpu")
    assert lines[0] == kernels.HEADER
    rows = _body_rows(lines)
    assert [r.split("\t")[0] for r in rows] == ["torch", "setop_popcnt", "setop_intersect"]
    for row in rows:
        cols = row.split("\t")
        assert len(cols) == 6 and "MISMATCH" not in row and cols[1] == str(1 << 14)
    # the set-algebra rows are timed like the torch row (the plain version
    # on the CPU), priced at 2 and 4 bytes per word
    for row, bytes_per_word in zip(rows, (2, 2, 4)):
        cols = row.split("\t")
        t_us, mwords, gbs = float(cols[2]), float(cols[3]), float(cols[4])
        assert t_us > 0
        assert mwords == pytest.approx((1 << 14) / t_us, rel=0.01, abs=0.51)
        assert gbs == pytest.approx(bytes_per_word * (1 << 14) / t_us / 1e3, rel=0.01, abs=0.051)
        vs = cols[5].rstrip("!")
        assert vs == "n/a" or float(vs) >= 0
    footer = [ln for ln in lines if ln.startswith("[roofline")]
    assert len(footer) <= 1 and all(ln.split("\t")[0] in (
        "[roofline:read_sum]", "[roofline:read_xor_cuda]",
        "[roofline:read_sum+read_xor_cuda]") for ln in footer)


def test_roster_flags_a_mismatch(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "_rows", lambda dev: {
        "torch": ("x", lambda a: torch.zeros(32, dtype=torch.int64), "streams")})
    lines = kernels.run(n_words=1 << 12, iters=1, cache_dir=str(tmp_path), device="cpu")
    assert f"torch\t{1 << 12}\tMISMATCH" in lines


def test_roster_gates_against_the_cached_oracle(monkeypatch, tmp_path):
    """The torch row is checked against the counters in the cache: a
    poisoned cache entry makes it a MISMATCH."""
    n = 1 << 12
    kernels.run(n_words=n, iters=1, cache_dir=str(tmp_path), device="cpu")
    files = list(tmp_path.glob("bench_oracle_*.npy"))
    assert len(files) == 1
    np.save(files[0], np.load(files[0]) + 1)
    monkeypatch.setattr(kernels, "defended_roofline", lambda *a, **k: (float("nan"), "none"))
    lines = kernels.run(n_words=n, iters=1, cache_dir=str(tmp_path), device="cpu")
    assert f"torch\t{n}\tMISMATCH" in lines


def test_roster_row_bytes():
    planes = torch.zeros((3, 24, 8, 128), dtype=torch.int32)
    assert kernels._row_bytes("cuda", None, 100) == 200
    assert kernels._row_bytes("cuda_pre", planes, 100) == 3 * 24 * 4096
    assert kernels._row_bytes("cuda_pre_packed_report", planes, 100) == 3 * 20 * 4096


def test_instrumented_on_the_cpu(capsys):
    lines = instrumented.run_all(n=1 << 12, iters=1, device="cpu")
    assert lines[0] == instrumented.HEADER
    assert capsys.readouterr().err == f"note: roofline: host memcpy, over {2 << 12} bytes\n"
    rows = instrumented.rows(lines)
    names = [ln.split("\t")[0] for ln in rows]
    assert names[0] == "numpy" and names[-1] == "torch"
    assert all(ln.endswith("\tok") and len(ln.split("\t")) == 8 for ln in rows)
    assert all(ln.split("\t")[6] != "n/a" for ln in rows)   # the column is printed
    # the host library built, so the perf block follows the rows
    assert lines[len(rows) + 1] == "" and len(lines) > len(rows) + 2


@pytest.mark.parametrize("n,want", [(1 << 20, 256 << 20), (0, 256 << 20), (128 << 20, 256 << 20),
                                    ((128 << 20) + 1, (256 << 20) + 2), (256 << 20, 512 << 20)])
def test_roofline_is_measured_beyond_the_l2(n, want):
    """The card's read roofline of an n-word run: over the column's 2n
    bytes, but never under 256 MiB (5x the H100's 50 MB L2): at the
    subcommand's default -n 1048576 the 2 MiB column sits in the L2."""
    assert instrumented.roofline_bytes(n) == want >= instrumented.ROOFLINE_MIN_BYTES


def test_instrumented_prices_the_card_rows_at_the_floor_size(monkeypatch, capsys):
    seen = []

    def roof(n_bytes, device=None):
        seen.append(n_bytes)
        return 3.0e12

    monkeypatch.setattr(instrumented, "defended_roofline", roof)
    monkeypatch.setattr(instrumented, "timing_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(instrumented, "get_function",
                        lambda n, impl, device: flagstat_numpy)
    monkeypatch.setattr(instrumented.native_host, "available", lambda: False)
    lines = instrumented.run_all(n=1 << 10, iters=1)
    assert seen == [256 << 20]
    assert capsys.readouterr().err == (f"note: roofline: defended read on cuda, "
                                       f"over {256 << 20} bytes\n")
    rows = [ln.split("\t") for ln in lines[1:]]
    assert [r[0] for r in rows] == ["numpy", "torch", "cuda", "cuda_pre", "cuda_words"]
    assert all(r[6] != "n/a" and r[7] == "ok" for r in rows)


def test_inmemory_and_instrumented_cli_on_the_cpu(capsys):
    assert cli.main(["inmemory", "-n", "5000", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out][-1] == "torch"
    assert all(ln.endswith("OK") for ln in out)
    assert cli.main(["instrumented", "-n", "4096", "-i", "1", "--no-roofline",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == instrumented.HEADER
    assert all(ln.endswith("\tok") for ln in instrumented.rows(out))
    block = out[out.index("") + 1:]
    assert block[0].startswith(("kernel\twords\tcounted", "perf_event unavailable: "))


def test_kernels_cli_without_a_card_exits_with_one_line():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    r = subprocess.run([sys.executable, "-m", "libflagstats_tpu_torch", "kernels", "-n", "65536"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    err = r.stderr.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0]


def test_stage_decomposition_small_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(SD, "KS_FAST", (1, 2, 3))
    monkeypatch.setattr(SD, "KS_SLOW", (1, 2, 3))
    monkeypatch.setattr(SD, "FIT_ITERS", 1)
    monkeypatch.setattr(SD, "FIT_ATTEMPTS", 1)
    monkeypatch.setattr(SD, "R_START", dict.fromkeys(SD.STAGES, 1))
    monkeypatch.setattr(SD, "R_CAP", 2)
    monkeypatch.setattr(SD, "R_CAP_COUNT", 2)
    monkeypatch.setattr(refcache, "CACHE_DIR", str(tmp_path))
    out = SD.run(n_words=8 * 65536, device="cpu")
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(out))
    assert last["n_words"] == 8 * 65536 and last["device"] == "cpu"
    assert set(last["shadow"]) == {"read", "full", "pre", "transpose@1", "count@1",
                                   "transform@1"}
    assert set(last["compute"]) == set(SD.STAGES)
    for stage in SD.STAGES:
        c = last["compute"][stage]
        assert len(c["r"]) == 2 and c["r"][1] == 2 * c["r"][0]
        assert c["alu_ms"] is None or c["alu_ms"] > 0
    assert last["model_ops"] == SD.MODEL_OPS
    assert set(last["summary"]) == {"alu_total_ms", "t_read_ms", "t_full_ms",
                                    "full_overhang_ms", "full_predicted_ms"}


def test_stage_decomposition_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SD.run(n_words=65536)
    assert SD.main() == 1


def test_scaling_sweep_on_the_cpu():
    res = multihost.scaling_sweep(n_words=1 << 12, devices=["cpu", "cpu"], iters=1)
    assert [r["devices"] for r in res] == [1, 2]
    assert all(r["words_per_s"] > 0 and r["min_s"] > 0 for r in res)
    assert res[0]["scaling_efficiency"] == 1.0
    res = multihost.scaling_sweep(n_words=1 << 12, devices=["cpu"] * 4, device_counts=[1, 4],
                                  iters=1, impl="torch")
    assert [r["devices"] for r in res] == [1, 4]


def test_setop_rows_skip_an_odd_word_count_and_flag_a_mismatch(monkeypatch, tmp_path):
    lines = kernels.run(n_words=(1 << 12) + 1, iters=1, cache_dir=str(tmp_path), device="cpu")
    rows = _body_rows(lines)[1:]
    assert [r.split("\t") for r in rows] == [
        [name, str((1 << 12) + 1), "skipped:odd word count", "-", "-", "-"]
        for name in kernels.SETOP_ROWS]
    right = kernels.setop_count_cuda
    monkeypatch.setattr(kernels, "setop_count_cuda",
                        lambda a, b, op: right(a, b, op) + (op == "intersect"))
    lines = kernels.run(n_words=1 << 12, iters=1, cache_dir=str(tmp_path), device="cpu")
    rows = _body_rows(lines)[1:]
    assert rows[0].startswith("setop_popcnt\t4096\t") and "MISMATCH" not in rows[0]
    assert rows[1] == "setop_intersect\t4096\tMISMATCH"

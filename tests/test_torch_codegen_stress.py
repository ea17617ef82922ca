"""The port's codegen and stress tools against the JAX package's on the
CPU: codegen prints the JAX tool's lines, line for line, plus the check
of K6's word table; stress at a fixed seed draws and prints the JAX
tool's rounds and both pass; a planted wrong count makes the port's
stress exit 1 with the MISMATCH line."""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import words_kernels as W
from libflagstats_tpu_torch.tools import codegen, stress

REPO = Path(__file__).resolve().parent.parent
STRESS_ARGS = ["--seed", "20261017", "--rounds", "3", "--max-words", "50000"]


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_codegen_prints_the_jax_tools_lines_and_the_word_table_check(capsys):
    assert _jax_tool("codegen").main() == 0
    jax_lines = capsys.readouterr().out.splitlines()
    out = codegen.run()
    assert capsys.readouterr().out.splitlines() == out["lines"]
    assert out["ok"] and out["lines"][-1] == "OK"
    assert out["lines"][-2] == codegen.WORD_TABLE_LINE
    assert out["lines"][:-2] + out["lines"][-1:] == jax_lines
    assert codegen.main([]) == 0


def test_codegen_fails_on_a_wrong_word_table(monkeypatch, capsys):
    right = W.word_table

    def wrong(device=None):
        t = right(device).clone()
        t[0x263] ^= 1 << 20     # one QC-fail entry, one bit of its high field
        return t

    monkeypatch.setattr(W, "word_table", wrong)
    assert codegen.main([]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("codegen: error: check failed: K6 word table")
    assert "[611]" in err[0]


def _without_times(text: str) -> list[str]:
    return [re.sub(r" \([0-9.]+s\)", "", ln) for ln in text.splitlines()]


def test_stress_equals_the_jax_tool_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["stress.py", *STRESS_ARGS])
    assert _jax_tool("stress").main() == 0
    jax_lines = _without_times(capsys.readouterr().out)
    assert stress.main([*STRESS_ARGS, "--device", "cpu"]) == 0
    lines = _without_times(capsys.readouterr().out)
    assert lines == jax_lines
    assert lines[0] == "[stress] seed=20261017 (rerun with --seed 20261017 to reproduce)"
    assert lines[-1] == "stress OK: 3 rounds x 3 impls"
    out = stress.run(3, 50_000, seed=20261017, device="cpu")
    assert out["ok"] and out["impls"] == ["numpy", "native", "torch"]
    # the rounds the JAX tool draws from the same seed
    rng = np.random.default_rng(20261017)
    want = []
    for _ in range(3):
        n = int(rng.integers(0, 50_000))
        hi = int(rng.choice([0x1000, 0x10000]))
        rng.integers(0, hi, size=n, dtype=np.uint16)
        want.append((n, hi))
    assert out["rounds"] == want


def test_stress_impls_on_the_card_are_the_seven():
    assert stress.impls_for(torch.device("cuda")) == [
        "numpy", "native", "torch", "cuda", "cuda_report", "cuda_pre", "cuda_words"]
    assert stress.impls_for(torch.device("cpu")) == ["numpy", "native", "torch"]


@pytest.mark.parametrize("bad", ["numpy", "native", "torch"])
def test_stress_exits_1_on_a_planted_mismatch(monkeypatch, capsys, bad):
    right = D.flagstats_u16

    def planted(x, impl=None, device=None):
        got = right(x, impl=impl, device=device)
        if impl == bad:
            got = got.copy()
            got[13] += 1
        return got

    monkeypatch.setattr(stress.D, "flagstats_u16", planted)
    assert stress.main([*STRESS_ARGS, "--device", "cpu"]) == 1
    lines = capsys.readouterr().out.splitlines()
    n = stress.run(1, 50_000, seed=20261017, device="cpu")["rounds"][0][0]
    capsys.readouterr()
    assert lines[1].startswith(f"MISMATCH round=0 impl={bad} n={n} hi=")
    assert lines[1].endswith("seed=20261017")
    assert lines[2].startswith("ref: ") and sum(ln.startswith("got: ") for ln in lines) == 1


def test_stress_holds_cuda_report_on_the_report_counters_only(monkeypatch, capsys):
    """A wrong masked counter of the report impl is no mismatch; a wrong
    report counter is. The card impls are driven through their CPU
    paths (the plain versions) with the card's impl list."""
    right = D.flagstats_u16

    def report_impl(x, impl=None, device=None):
        if impl in stress.CARD_IMPLS:
            return right(x, impl=impl, device="cpu")
        return right(x, impl=impl, device=device)

    monkeypatch.setattr(stress.D, "flagstats_u16", report_impl)
    monkeypatch.setattr(stress.D, "auto_impl", lambda n, device=None: "cuda")
    monkeypatch.setattr(stress, "impls_for", lambda dev: ["numpy", "cuda_report"])
    out = stress.run(2, 20_000, seed=3, device="cuda")
    assert out["ok"] and out["lines"][-1] == "stress OK: 2 rounds x 2 impls"

    def wrong_report(x, impl=None, device=None):
        got = report_impl(x, impl, device)
        if impl == "cuda_report":
            got = got.copy()
            got[0] += 1             # total (QC-pass): a report counter
        return got

    monkeypatch.setattr(stress.D, "flagstats_u16", wrong_report)
    out = stress.run(2, 20_000, seed=3, device="cuda")
    assert not out["ok"] and out["lines"][1].startswith("MISMATCH round=0 impl=cuda_report")

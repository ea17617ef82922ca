"""The port's host tools against the JAX package's on the CPU:
alignment_study's rows, codec_sweep_na12878's table and counters at a
tiny scale, and one world of multihost_scaling with two real gloo
processes."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from libflagstats_tpu_torch.io import codec as C
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.tools import alignment_study, codec_sweep_na12878, multihost_scaling

REPO = Path(__file__).resolve().parent.parent
TINY_SCALE = 8192      # 100,652 words of the synthetic NA12878 column


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- alignment_study ----

def test_alignment_study_rows_have_the_jax_tools_keys_and_offsets():
    jax_rows = _jax_tool("alignment_study").run(1 << 16, 1)
    rows = alignment_study.run(1 << 16, 1)
    assert [sorted(r) for r in rows] == [sorted(r) for r in jax_rows]
    assert [(r["kernel"], r["offset_bytes"]) for r in rows] == \
        [(r["kernel"], r["offset_bytes"]) for r in jax_rows]
    assert [r["offset_bytes"] for r in rows] == list(alignment_study.OFFSETS) * 2
    assert all(r["min_s"] > 0 and r["gwords_per_s"] > 0 for r in rows)


@pytest.mark.parametrize("offset", alignment_study.OFFSETS)
def test_alignment_study_places_words_at_the_offset(offset):
    x = generate_flags(1000, seed=offset, full_range=True)
    v = alignment_study._place(x, offset)
    assert v.ctypes.data % 64 == offset and np.array_equal(v, x)


def test_alignment_study_prints_its_table(capsys):
    assert alignment_study.main(["--n", "4096", "--iters", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == alignment_study.HEADER and len(lines) == 9
    cols = [ln.split("\t") for ln in lines[1:]]
    assert [c[1] for c in cols] == ["0", "2", "6", "62"] * 2
    assert [c[4] for c in cols if c[1] == "0"] == ["1.000", "1.000"]


def test_alignment_study_without_the_host_library(monkeypatch, capsys):
    monkeypatch.setattr(alignment_study.native_host, "available", lambda: False)
    assert alignment_study.main(["--n", "4096"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("alignment_study: error: the native host library")


# ---- codec_sweep_na12878 ----

def test_codec_sweep_equals_the_jax_table_and_the_oracle(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["codec_sweep_na12878.py", str(TINY_SCALE)])
    assert _jax_tool("codec_sweep_na12878").main() == 0
    jax_rows = [ln.split("\t") for ln in capsys.readouterr().out.splitlines()]
    assert codec_sweep_na12878.main([str(TINY_SCALE), "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    rows = [ln.split("\t") for ln in cap.out.splitlines()]
    assert rows[0] == jax_rows[0] == codec_sweep_na12878.HEADER.split("\t")
    assert len(rows) == 1 + 39 == len(jax_rows)
    # codec, config, compressed MB and ratio: the same bytes in both
    assert [r[:4] for r in rows] == [r[:4] for r in jax_rows]
    assert [tuple(r[:2]) for r in rows[1:]] == \
        [(c, label) for c, _, label in codec_sweep_na12878.CONFIGS]
    assert "torch tier on cpu" in cap.err


def test_codec_sweep_counters_equal_the_oracle_on_both_paths(monkeypatch):
    seen = []
    right = codec_sweep_na12878.D.flagstats_u16

    def spy(x, impl=None, device=None):
        got = right(x, impl=impl, device=device)
        seen.append(got.copy())
        return got

    monkeypatch.setattr(codec_sweep_na12878.D, "flagstats_u16", spy)
    out = codec_sweep_na12878.run(TINY_SCALE, device="cpu")
    assert out["checked"] == ["lz4", "zstd", "raw"]
    assert out["flag_s"] > 0 and len(out["rows"]) == 39
    x, _ = codec_sweep_na12878.synth_na12878(scale_divisor=TINY_SCALE, seed=0)
    ref = flagstat_numpy(x)
    # 1 + FLAG_RUNS counts of the term, one of each family's decoded column
    assert len(seen) == 1 + codec_sweep_na12878.FLAG_RUNS + 3
    assert all(np.array_equal(c, ref) for c in seen)


def test_codec_sweep_fails_on_a_wrong_fused_count(monkeypatch, capsys):
    right = codec_sweep_na12878.native_host.flagstat_framed_native

    def wrong(path, codec, **kw):
        counters, n = right(path, codec, **kw)
        counters = counters.copy()
        counters[25] += 1
        return counters, n

    monkeypatch.setattr(codec_sweep_na12878.native_host, "flagstat_framed_native", wrong)
    assert codec_sweep_na12878.main([str(TINY_SCALE), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "codec_sweep_na12878: MISMATCH: lz4 HC_c2" in err


# ---- multihost_scaling ----

@pytest.fixture
def framed(tmp_path):
    x = generate_flags(300_000, seed=23, full_range=True)
    path = tmp_path / "s.lz4"
    C.write_framed(path, x, codec="lz4", level=1, block_bytes=1 << 16)
    return path, x


def test_multihost_scaling_two_gloo_processes_count_the_file(framed):
    path, x = framed
    r = multihost_scaling.run_world(2, "framed", str(path), threads=1, iters=1, timeout=240)
    assert r["nproc"] == 2 and r["threads"] == 1
    ref = flagstat_numpy(x)
    assert r["records"] == int(ref[9] + ref[25]) == x.size
    assert r["wall_s"] > 0 and r["words_per_s"] == r["records"] / r["wall_s"]


def test_multihost_scaling_one_world_counts_every_file(framed, tmp_path):
    from libflagstats_tpu_torch.io import bamio

    path, x = framed
    y = generate_flags(50_000, seed=29, full_range=True)
    bam = tmp_path / "s.bam"
    bamio.write_bam(bam, y, level=1, payload="realistic")
    world = multihost_scaling.run_worlds(1, {"framed": str(path), "bam": str(bam)}, threads=2,
                                         iters=2, timeout=240)
    assert list(world) == ["framed", "bam"]
    assert [world[k]["records"] for k in world] == [x.size, y.size]
    assert all(w["nproc"] == 1 and w["threads"] == 2 and w["wall_s"] > 0 for w in world.values())


def test_multihost_scaling_skips_a_missing_file(tmp_path, capsys):
    missing = str(tmp_path / "none")
    assert multihost_scaling.main(["--file", missing, "--sam-gz", missing, "--bam", missing]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["[skip] framed", "[skip] bgzf_sam", "[skip] bam"]
    assert all("tools.na12878_run --keep first" in ln for ln in lines)


def test_multihost_scaling_defaults_are_the_files_na12878_run_keeps(tmp_path, monkeypatch,
                                                                     capsys):
    """The files na12878_run --keep leaves: framed LZ4 at scale 1 (level
    1), the BGZF SAM at scale 1, the realistic BAM at scale 4; with none
    there, each is skipped and the tool exits 1."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    base = tmp_path / "na12878"
    assert multihost_scaling.default_files() == {
        "framed": str(base / "na12878_s1_l1.lz4"), "bgzf_sam": str(base / "na12878_s1.sam.gz"),
        "bam": str(base / "na12878_s4_real.bam")}
    assert multihost_scaling.main([]) == 1
    out = capsys.readouterr().out
    assert all(f"{p} missing" in out for p in multihost_scaling.default_files().values())

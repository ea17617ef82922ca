"""The port's copies of the numpy-only modules equal their originals,
``import libflagstats_tpu_torch`` pulls in no jax, and the kernel tiers
raise rather than fall back when there is no CUDA device."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import libflagstats_tpu.datasets as jdatasets
import libflagstats_tpu.flags as jflags
import libflagstats_tpu.oracle as joracle
import libflagstats_tpu.report as jreport
from libflagstats_tpu.ops import bitslice as jB

import libflagstats_tpu_torch as L
import libflagstats_tpu_torch.datasets as tdatasets
import libflagstats_tpu_torch.flags as tflags
import libflagstats_tpu_torch.oracle as toracle
import libflagstats_tpu_torch.report as treport
from libflagstats_tpu_torch.ops import bitslice as tB
from libflagstats_tpu_torch.ops import cuda_build
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.parallel import flagstat_sharded
from libflagstats_tpu_torch.tools import (crossover_sweep, kernel_sweep, packed_probe,
                                          pipeline_balance)

REPO = Path(__file__).resolve().parent.parent


def _public_constants(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not isinstance(v, type(np))}


@pytest.mark.parametrize("pair", [(jflags, tflags), (jB, tB)],
                         ids=["flags", "bitslice"])
def test_constant_tables_equal(pair):
    j, t = pair
    assert _public_constants(j) == _public_constants(t)
    assert _public_constants(t)


@pytest.mark.parametrize("needed", ["full", "report"])
def test_pruned_pairs_equal(needed):
    rows = jB.NEEDED_ROWS if needed == "full" else jB.REPORT_NEEDED_ROWS
    assert tB.pruned_pairs(rows) == jB.pruned_pairs(rows)
    for j, _ in jB.TRANSPOSE_STAGES:
        assert tB.swap_pairs(j) == jB.swap_pairs(j)


def test_bitslice_numpy_spec_equal():
    rng = np.random.default_rng(3)
    regs = [rng.integers(0, 1 << 32, size=(4, 8), dtype=np.uint32) for _ in range(32)]
    for prune in (False, True):
        for a, b in zip(jB.transpose32_np(regs, prune=prune),
                        tB.transpose32_np(regs, prune=prune)):
            np.testing.assert_array_equal(a, b)
    for report in (False, True):
        for a, b in zip(jB.transform_planes(regs[:12], report=report),
                        tB.transform_planes(regs[:12], report=report)):
            assert (a is None and b is None) or np.array_equal(a, b)
    np.testing.assert_array_equal(jB.popcount32_np(regs[0]), tB.popcount32_np(regs[0]))
    x = joracle.generate_flags(10_001, seed=4, full_range=True)
    np.testing.assert_array_equal(jB.flagstat_bitsliced_np(x), tB.flagstat_bitsliced_np(x))


@pytest.mark.parametrize("n", [0, 1, 777, 5000])
def test_oracle_equal(n, full_range):
    x = joracle.generate_flags(n, seed=n, full_range=full_range)
    np.testing.assert_array_equal(x, toracle.generate_flags(n, seed=n, full_range=full_range))
    np.testing.assert_array_equal(joracle.transform_words(x), toracle.transform_words(x))
    np.testing.assert_array_equal(joracle.flagstat_numpy(x), toracle.flagstat_numpy(x))
    np.testing.assert_array_equal(
        joracle.flagstat_loop(x[:500], count_paired=True),
        toracle.flagstat_loop(x[:500], count_paired=True))


def test_report_equal():
    c = joracle.flagstat_numpy(joracle.generate_flags(20_000, seed=9, full_range=True))
    assert jreport.counters_to_report(c).text() == treport.counters_to_report(c).text()
    assert jreport.counters_to_dict(c, 20_000) == treport.counters_to_dict(c, 20_000)
    zero = np.zeros(32, np.uint64)
    assert jreport.counters_to_report(zero).text() == treport.counters_to_report(zero).text()


def test_datasets_equal():
    ja, je = jdatasets.synth_na12878(1000)
    ta, te = tdatasets.synth_na12878(1000)
    assert ja.dtype == ta.dtype and ja.tobytes() == ta.tobytes()
    np.testing.assert_array_equal(je, te)
    assert jdatasets.na12878_report_values(1) == tdatasets.na12878_report_values(1)
    assert jdatasets.na12878_categories(7) == [
        jdatasets.FlagCategory(c.flag, c.count) for c in tdatasets.na12878_categories(7)]


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import libflagstats_tpu_torch, libflagstats_tpu_torch.datasets\n"
        "import libflagstats_tpu_torch.ops.kernels, libflagstats_tpu_torch.ops.cuda_build\n"
        "import libflagstats_tpu_torch.ops.dispatch, libflagstats_tpu_torch.ops.torch_ops\n"
        "import libflagstats_tpu_torch.ops.native_host, libflagstats_tpu_torch.io.stream\n"
        "import libflagstats_tpu_torch.io.codec, libflagstats_tpu_torch.bench.profiling\n"
        "import libflagstats_tpu_torch.ops.words_kernels, libflagstats_tpu_torch.parallel\n"
        "import libflagstats_tpu_torch.parallel.sharded, libflagstats_tpu_torch.parallel.multihost\n"
        "import libflagstats_tpu_torch.ops.probe_kernels, libflagstats_tpu_torch.bench.harness\n"
        "import libflagstats_tpu_torch.bench.refcache, libflagstats_tpu_torch.bench.kernels\n"
        "import libflagstats_tpu_torch.bench.instrumented, libflagstats_tpu_torch.cli\n"
        "import libflagstats_tpu_torch.__main__, libflagstats_tpu_torch.tools.stage_decomposition\n"
        "import libflagstats_tpu_torch.ops.setalgebra, libflagstats_tpu_torch.tools.packed_probe\n"
        "import libflagstats_tpu_torch.tools.kernel_sweep, libflagstats_tpu_torch.tools.crossover_sweep\n"
        "import libflagstats_tpu_torch.tools.pipeline_balance, libflagstats_tpu_torch.tools.sass_count\n"
        "import libflagstats_tpu_torch.io.samio, libflagstats_tpu_torch.io.bamio\n"
        "import libflagstats_tpu_torch.io.cramio, libflagstats_tpu_torch.tools.na12878_run\n"
        "import libflagstats_tpu_torch.tools.codegen, libflagstats_tpu_torch.tools.stress\n"
        "import libflagstats_tpu_torch.tools.alignment_study\n"
        "import libflagstats_tpu_torch.tools.codec_sweep_na12878\n"
        "import libflagstats_tpu_torch.tools.multihost_scaling\n"
        "import libflagstats_tpu_torch.bench.perf_native, libflagstats_tpu_torch.graft_entry\n"
        "import libflagstats_tpu_torch.calibration\n"
        "from libflagstats_tpu_torch import flagstat_file, cli\n"
        "from libflagstats_tpu_torch.io import sniff_format, read_flags_auto, native_lib\n"
        "assert native_lib.load_readers() is not None, native_lib.READERS_BUILD_ERROR\n"
        "assert native_lib.load_perf() is not None, native_lib.PERF_BUILD_ERROR\n"
        "assert native_lib.load_columns() is not None, native_lib.COLUMNS_BUILD_ERROR\n"
        "import runpy; runpy.run_path('chip_smoke.py')  # its imports, no main()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'libflagstats_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")


@pytest.mark.parametrize("call", [
    lambda x: L.flagstats_u16(x, impl="cuda"),
    lambda x: L.flagstats_u16(x, impl="cuda_report"),
    lambda x: L.flagstats_u16(x, device="cuda"),
    lambda x: L.pospopcnt_u16(x, impl="cuda"),
    lambda x: L.pospopcnt_u16(x, device="cuda"),
    lambda x: L.get_function(x.size, impl="cuda")(x),
    lambda x: L.flagstats(x, impl="cuda"),
    lambda x: L.flagstats_u16(x, impl="cuda_words"),
    lambda x: flagstat_sharded(x, devices=["cuda"], impl="cuda_words"),
    lambda x: flagstat_sharded(x, devices=["cuda", "cuda"]),
    lambda x: L.popcnt(x, impl="cuda"),
    lambda x: L.intersect_count(x, x),
    lambda x: L.union_count(x, x, device="cuda"),
    lambda x: L.diff_count(torch.from_numpy(x), torch.from_numpy(x)),
    lambda x: packed_probe.run(groups=1),
    lambda x: kernel_sweep.run(n_words=x.size),
    lambda x: crossover_sweep.run([x.size]),
    lambda x: pipeline_balance.run(n_words=x.size),
    lambda x: L.flagstat_sharded(x),
], ids=["flagstat", "report", "device", "pospopcnt", "pospopcnt-device",
        "get_function", "flagstats", "words", "sharded-words", "sharded-auto",
        "popcnt", "intersect", "union-device", "diff-tensors",
        "packed_probe", "kernel_sweep", "crossover_sweep", "pipeline_balance",
        "sharded-top-level"])
def test_cuda_tiers_raise_without_a_device(call):
    _no_cuda()
    x = joracle.generate_flags(3000, seed=1)   # 6000 bytes: a bitmap too
    before = dict(K.LAUNCHES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(x)
    assert K.LAUNCHES == before


def test_kernel_wrapper_routes_only_cpu_tensors_to_plain():
    x = torch.from_numpy(joracle.generate_flags(5000, seed=2, full_range=True))
    before = dict(K.LAUNCHES)
    for mode in K.MODES:
        assert torch.equal(K.stream_sums_cuda(x, mode), K.stream_sums_plain(x, mode))
    assert K.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.stream_sums_cuda(torch.zeros(64, dtype=torch.int16, device="meta"))
    with pytest.raises(ValueError, match="unknown mode"):
        K.stream_sums_cuda(x, "flagstat_pre")
    with pytest.raises(ValueError, match="uint16"):
        K.stream_sums_cuda(x.to(torch.int32))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    _no_cuda()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build()

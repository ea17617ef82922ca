"""The port's tuning tools on the CPU, each with device="cpu" at a small
size: the rows they print, OK on good data, exit code 1 and MISMATCH /
FAIL when a kernel wrapper is patched to return a wrong result, the
one-line exit without a card (stress and codec_sweep_na12878 too);
na12878_run at 1/8192 of NA12878, framed and through three containers,
against the JAX package's column and flagstat_file; and the pieces they
stand on: the ``blocks`` argument of the kernel wrappers,
``harness.wall_time_min`` and ``profiling.trace``."""
import glob
import json

import numpy as np
import pytest
import torch

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch.bench import harness, profiling, refcache
from libflagstats_tpu_torch.io import codec as C
from libflagstats_tpu_torch.io import stream as S
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import probe_kernels as P
from libflagstats_tpu_torch.ops import words_kernels as W
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.tools import (codec_sweep_na12878, crossover_sweep, kernel_sweep,
                                          na12878_run, packed_probe, pipeline_balance,
                                          sass_count, stress)

TOOLS = (packed_probe, kernel_sweep, crossover_sweep, pipeline_balance, na12878_run, stress,
         codec_sweep_na12878)


@pytest.fixture
def quick(monkeypatch, tmp_path):
    """One repetition count set, one run per point, one attempt."""
    for mod in (packed_probe, kernel_sweep):
        monkeypatch.setattr(mod, "KS", (1, 2, 3))
    for mod in (packed_probe, kernel_sweep, crossover_sweep):
        monkeypatch.setattr(mod, "FIT_ITERS", 1)
        monkeypatch.setattr(mod, "FIT_ATTEMPTS", 1)
    monkeypatch.setattr(crossover_sweep, "WALL_ITERS", 1)
    monkeypatch.setattr(crossover_sweep, "_ks", lambda n: (1, 2, 3))
    monkeypatch.setattr(kernel_sweep, "WAVES", (0.5, 1))
    monkeypatch.setattr(refcache, "CACHE_DIR", str(tmp_path))


# ---- packed_probe ----

def test_packed_probe_on_the_cpu(quick, capsys):
    out = packed_probe.run(groups=8, device="cpu")
    assert capsys.readouterr().out.splitlines() == out["lines"]
    assert out["ok"] and out["lines"][0] == packed_probe.HEADER
    rows = [ln.split("\t") for ln in out["lines"][1:4]]
    assert [r[0] for r in rows] == ["full32", "sub24", "pack24"] == list(out["times"])
    assert all(len(r) == 8 and r[-1] == "OK" and float(r[1]) >= 0 for r in rows)
    # each case is priced at the bytes of the rows it folds
    ms = {r[0]: float(r[1]) for r in rows}
    own = {r[0]: float(r[2]) for r in rows}
    equiv = {r[0]: float(r[3]) for r in rows}
    for name, share in (("full32", 1.0), ("sub24", 0.75), ("pack24", 0.75)):
        assert own[name] == pytest.approx(share * equiv[name], rel=0.05, abs=0.11), (name, ms)
    assert out["lines"][4].startswith("# pack24/full32 = ")
    assert out["lines"][5].startswith("# sub24/full32  = ")


def test_packed_probe_flags_a_wrong_fold(quick, monkeypatch, capsys):
    right = P.fold_xor_cuda
    monkeypatch.setattr(P, "fold_xor_cuda", lambda p, rows=None: right(p, rows) ^ (rows is None))
    assert packed_probe.main(["--device", "cpu", "--groups", "2"]) == 1
    rows = [ln.split("\t") for ln in capsys.readouterr().out.splitlines()[1:4]]
    assert [r[-1] for r in rows] == ["MISMATCH", "OK", "MISMATCH"]


# ---- kernel_sweep ----

def test_kernel_sweep_on_the_cpu(quick, capsys):
    out = kernel_sweep.run(n_words=2 * 65536, device="cpu")
    assert capsys.readouterr().out.splitlines() == out["lines"]
    assert out["ok"] and out["lines"][0].startswith("roofline (agreed): ")
    rows = out["lines"][1:]
    modes = ["report", "full", "pre_report", "pre_full", "pre_packed_report", "pre_packed_full",
             "words"]
    assert [r.split()[0] for r in rows] == [f"mode={m}" for m in modes for _ in (0, 1)]
    assert all(r.endswith(", OK") and " ms, " in r and "roofline" in r for r in rows)
    assert [r.split()[1] for r in rows[:2]] == ["blocks=4", "blocks=8"]
    assert all(("words-equiv" in r) == ("packed" in r) for r in rows)
    assert set(out["times"]) == {(m, w) for m in modes for w in (0.5, 1)}


def test_kernel_sweep_exits_1_on_a_mismatch(quick, monkeypatch, capsys):
    right = K.stream_sums_cuda
    monkeypatch.setattr(K, "stream_sums_cuda",
                        lambda x, mode="flagstat", blocks=None: right(x, mode, blocks) + (
                            mode == "flagstat_report"))
    assert kernel_sweep.main(["-n", "65536", "--device", "cpu"]) == 1
    rows = capsys.readouterr().out.splitlines()[1:]
    assert [r.endswith("MISMATCH") for r in rows] == [True, True] + [False] * 12
    monkeypatch.setattr(K, "stream_sums_cuda", right)
    assert kernel_sweep.main(["-n", "65536", "--device", "cpu"]) == 0


def test_blocks_argument_of_the_wrappers():
    x = torch.from_numpy(generate_flags(70_000, seed=3, full_range=True))
    planes = torch.from_numpy(L.ops.bitslice.pretranspose_host(x.numpy()))
    ref = K.stream_sums_cuda(x)
    # a CPU tensor takes the plain version, whatever the grid
    assert torch.equal(K.stream_sums_cuda(x, "flagstat", blocks=3), ref)
    assert torch.equal(K.stream_sums_pre_cuda(planes, blocks=5), ref)
    for bad in (0, -1, 2.0):
        with pytest.raises(ValueError, match="blocks"):
            K.stream_sums_cuda(x, blocks=bad)
        with pytest.raises(ValueError, match="blocks"):
            K.stream_sums_pre_cuda(planes, blocks=bad)
        with pytest.raises(ValueError, match="blocks"):
            W.stream_sums_words_cuda(x, blocks=bad)


# ---- crossover_sweep ----

@pytest.mark.parametrize("pospopcnt", [False, True], ids=["flagstat", "pospopcnt"])
def test_crossover_sweep_on_the_cpu(quick, capsys, pospopcnt):
    out = crossover_sweep.run([1024, 5000], pospopcnt=pospopcnt, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines == out["lines"]
    assert lines[0] == "# device=cpu" + (" mode=pospopcnt" if pospopcnt else "")
    assert lines[1] == crossover_sweep.HEADER
    table = [ln.split("\t") for ln in lines[2:4]]
    assert [r[0] for r in table] == ["1024", "5000"] and all(len(r) == 9 for r in table)
    for row, cols in zip(out["rows"], table):
        assert all(v > 0 for v in row[1:5])                 # numpy, native, torch wall and kernel
        assert all(v != v for v in row[5:])                 # no card: the card tiers' columns are nan
        assert cols[5:] == ["nan"] * 4
    tail = lines[4:]
    assert len(tail) == 7 and all(ln.startswith("# suggested ") for ln in tail[:6])
    assert all(("pospopcnt" in ln) == pospopcnt for ln in tail[:6])
    assert len(out["suggested"]) == 6
    assert all(v is None for k, v in out["suggested"].items()
               if k.startswith("CUDA_MIN") or " over cuda " in k)
    assert tail[6].startswith("# sizes where the native host count beats the device wall: [")


def test_first_size_rules():
    rows = [(1, 1.0, 0.1, 2.0, 2.0, float("nan"), float("nan")),
            (2, 3.0, 0.1, 2.0, 2.0, 1.0, 1.0),
            (3, 3.0, 2.0, 2.0, 2.0, 1.0, 3.0)]
    first = crossover_sweep._first_size
    assert first(rows, lambda r: r[3] < r[1]) == 2
    assert first(rows, lambda r: r[5] == r[5] and r[5] < min(r[1], r[3])) == 2
    assert first(rows, lambda r: r[6] == r[6] and r[6] < r[4]) == 2
    assert first(rows, lambda r: r[1] > 5) is None
    # a card tier (columns 7, 8) against cuda's wall (column 5): from its
    # first size of an unbroken run of wins to the end, else None
    nan = float("nan")
    tiers = [(1, 0, 0, 0, 0, 1.0, 0, 0.5, nan), (2, 0, 0, 0, 0, 1.0, 0, 2.0, 0.5),
             (3, 0, 0, 0, 0, 1.0, 0, 0.5, 0.5), (4, 0, 0, 0, 0, 1.0, 0, 0.5, 0.5)]
    assert crossover_sweep.card_tier_min(tiers, 7) == 3
    assert crossover_sweep.card_tier_min(tiers, 8) == 2
    assert crossover_sweep.card_tier_min(tiers[:1], 8) is None


# ---- pipeline_balance ----

def test_pipeline_balance_on_the_cpu(capsys):
    orig = S._chunk_sums
    out = pipeline_balance.run(n_words=300_000, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert S._chunk_sums is orig                              # the serial leg's swap is undone
    assert out["ok"] and list(out["walls"]) == ["overlapped", "serial", "native"]
    legs = [ln for ln in lines if ln.startswith("== ")]
    assert [ln.split(":")[0] for ln in legs] == ["== overlapped", "== serial", "== native"]
    assert all(ln.endswith("check=ok") for ln in legs)
    assert any(ln.startswith("warm-up [torch]") for ln in lines)
    assert any(ln.startswith("dispatch: ") for ln in lines)   # the SectionTimer tables
    assert list(out["benefit"]) == ["overlapped"]
    verdict = [ln for ln in lines if ln.startswith("overlap benefit [overlapped]: serial ")]
    assert len(verdict) == 1 and ("real overlap" in verdict[0]) == (
        out["benefit"]["overlapped"] > pipeline_balance.OVERLAP_MIN)


def test_pipeline_balance_prices_each_leg_at_its_fastest_run(monkeypatch, capsys):
    """Each leg runs RUNS times, an impl's overlapped and serial runs
    taking turns; every run is printed and checked, and the verdict's
    ratio is taken between the legs' fastest runs, so one slow run of a
    leg cannot flip it."""
    walls = {False: iter([0.30, 0.10, 0.20, 0.11]), True: iter([0.40, 0.13, 0.50])}
    order = []
    real = pipeline_balance._run

    def scripted(path, impl, timer, serial, device):
        counters, _ = real(path, impl, timer, serial, device)
        order.append(serial)
        return counters, next(walls[serial])

    monkeypatch.setattr(pipeline_balance, "_run", scripted)
    assert pipeline_balance.RUNS == 3
    out = pipeline_balance.run(n_words=20_000, skip_native=True, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    # the untimed warm-up (an overlapped run) takes the first wall
    assert out["runs"] == {"overlapped": [0.10, 0.20, 0.11], "serial": [0.40, 0.13, 0.50]}
    assert out["walls"] == {"overlapped": 0.10, "serial": 0.13}
    assert out["benefit"]["overlapped"] == pytest.approx(1.3)
    legs = [ln for ln in lines if ln.startswith("== ")]
    assert legs[0].startswith("== overlapped: wall 0.100s, the fastest of 0.100s 0.200s 0.110s")
    assert legs[1].startswith("== serial: wall 0.130s, the fastest of 0.400s 0.130s 0.500s")
    assert any("= 1.30x (real overlap)" in ln for ln in lines)
    # the warm-up, then o, s, o, s, o, s
    assert order == [False] + [False, True] * pipeline_balance.RUNS


def test_serial_leg_equals_overlapped_leg_equals_oracle(tmp_path):
    x = generate_flags(200_001, seed=5, full_range=True)
    path = tmp_path / "x.lz4"
    C.write_framed(path, x, codec="lz4", level=1, block_bytes=20_000)
    ref = flagstat_numpy(x)
    timer = profiling.SectionTimer()
    for serial in (False, True):
        c, wall = pipeline_balance._run(path, "torch", timer, serial, "cpu")
        np.testing.assert_array_equal(c, ref)
        assert wall > 0
    assert timer.counts["dispatch"] >= 2


def test_pipeline_balance_exits_1_on_wrong_counters(monkeypatch, capsys):
    right = S._chunk_sums

    def wrong(tally, chunk):
        right(tally, chunk)
        right(tally, chunk)        # every run counted twice

    monkeypatch.setattr(S, "_chunk_sums", wrong)
    assert pipeline_balance.main(["--n-words", "70000", "--device", "cpu", "--skip-native"]) == 1
    legs = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("== ")]
    assert len(legs) == 2 and all(ln.endswith("check=FAIL") for ln in legs)
    assert S._chunk_sums is wrong                             # restored to what the run found


# ---- na12878_run ----

NA_SCALE = 8192      # 100,651 words of the synthetic NA12878 column


@pytest.mark.parametrize("container", [None, "cram", "bam", "sam.gz"])
def test_na12878_run_on_the_cpu(tmp_path, capsys, container):
    """The framed stream and the container path at 1/8192 of NA12878:
    the published report holds, the counters equal the oracle over the
    JAX package's column and, for a container, the JAX package's
    flagstat_file on the same file."""
    import libflagstats_tpu as J
    from libflagstats_tpu.datasets import synth_na12878 as jax_synth
    from libflagstats_tpu.oracle import flagstat_numpy as jax_oracle

    argv = ["--scale", str(NA_SCALE), "--workdir", str(tmp_path), "--device", "cpu"]
    if container:
        argv += ["--container", container]
    assert na12878_run.main(argv) == 0
    assert "[check] published-report match: True" in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []                    # no --keep: the file is gone
    out = na12878_run.run(NA_SCALE, workdir=tmp_path, container=container, keep=True,
                          device="cpu")
    want = jax_oracle(jax_synth(NA_SCALE)[0])
    np.testing.assert_array_equal(out["counters"], want)
    assert out["ok"] and all(v > 0 for v in out["walls_s"].values())
    if container:
        path = tmp_path / f"na12878_s{NA_SCALE}.{container}"
        np.testing.assert_array_equal(J.flagstat_file(path), want)
        np.testing.assert_array_equal(
            na12878_run.run(NA_SCALE, workdir=tmp_path, container=container,
                            impl="native")["counters"], want)   # the file is reused
    capsys.readouterr()


def test_na12878_run_exits_1_on_a_mismatch_or_a_bad_request(tmp_path, monkeypatch, capsys):
    argv = ["--scale", str(NA_SCALE), "--workdir", str(tmp_path), "--device", "cpu",
            "--container", "cram"]
    assert na12878_run.main([*argv, "--payload", "realistic"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "FLAG column only" in err[0]
    real = na12878_run.na12878_report_values
    monkeypatch.setattr(na12878_run, "na12878_report_values",
                        lambda scale_divisor: {**real(scale_divisor), "singletons": -1})
    assert na12878_run.main(argv) == 1
    assert "[check] published-report match: False" in capsys.readouterr().out


# ---- without a card ----

@pytest.mark.parametrize("tool", TOOLS, ids=[t.__name__.split(".")[-1] for t in TOOLS])
def test_tools_exit_with_one_line_without_a_card(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    before = dict(K.LAUNCHES)
    assert tool.main([]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    err = cap.err.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0]
    assert err[0].startswith(tool.__name__.split(".")[-1] + ": error: ")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.run()
    assert K.LAUNCHES == before


# ---- the pieces ----

def test_wall_time_min_salts_every_call():
    x = torch.from_numpy(generate_flags(4096, seed=1, full_range=True))
    seen = []

    def fn(a):
        seen.append(a.clone())
        return a.sum()

    t = harness.wall_time_min(fn, x, iters=3, warmup=2, device="cpu")
    assert 0 < t < 1 and len(seen) == 5
    assert all(a.dtype == x.dtype and a.shape == x.shape for a in seen)
    assert all(not torch.equal(a.view(torch.int16), x.view(torch.int16)) for a in seen)
    distinct = {a.view(torch.int16).numpy().tobytes() for a in seen}
    assert len(distinct) == 5                                 # a fresh buffer each call
    slow = harness.wall_time_min(lambda a: [a.sum() for _ in range(200)], x, iters=2,
                                 warmup=1, device="cpu")
    assert slow > t


def test_wall_time_min_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.wall_time_min(lambda a: a, np.zeros(4, np.uint16))


def test_the_spin_before_a_timed_run_grows_with_its_calls(monkeypatch):
    """A run of k chained calls spins the card long enough for the host
    to queue all k (a wrapper costs the host 40-50 us a call): with a
    fixed spin, kernels faster than that were timed at the host's rate."""
    spins = []

    class FakeEvent:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    x = torch.zeros(8)
    for k in (4, 64, 260):
        assert harness._time_call(lambda a: a.sum(), x, k, torch.device("cuda")) == 1e-3
    assert spins == [harness.SPIN_CYCLES + k * harness.SPIN_CYCLES_PER_CALL for k in (4, 64, 260)]
    # at the H100's 1.98 GHz boost clock, at least 50 us of spin per call
    assert harness.SPIN_CYCLES_PER_CALL / 1.98e9 >= 50e-6


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "deep" / "trace"
    with profiling.trace(logdir) as where:
        assert where == str(logdir)
        torch.arange(1000).sum()
    files = glob.glob(str(logdir / "*.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("sum" in str(e.get("name", "")) for e in events)
    with pytest.raises(ZeroDivisionError):                    # the file is written on an error too
        with profiling.trace(logdir):
            1 / 0
    assert len(glob.glob(str(logdir / "*.trace.json"))) == 2


# ---- sass_count ----

SASS = """
        Function : _Z5otherv
        /*0000*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_124stream_sums_words_kernelEPKtlllPy
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
.L_x_1:
        /*0020*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0030*/                   LOP3.LUT R6, R4, 0x3ffc, RZ, 0xc0, !PT ;
        /*0040*/                   LDS R7, [R6+UR5] ;
        /*0050*/              @P0 BRA `(.L_x_2) ;
        /*0060*/                   LDG.E.U16 R8, desc[UR4][R2.64] ;
        /*0070*/                   IADD3 R8, R8, 0x1, RZ ;
.L_x_2:
        /*0080*/                   ISETP.NE.AND P1, PT, R8, RZ, PT ;
        /*0090*/              @!P1 BRA `(.L_x_3) ;
        /*00a0*/                   LOP3.LUT R9, R7, R9, R10, 0x96, !PT ;
        /*00b0*/                   SHF.R.U32.HI R11, RZ, 0x1, R9 ;
.L_x_3:
        /*00c0*/                   IADD3 R12, R12, 0x1, RZ ;
        /*00d0*/              @P2 BRA 0x20 ;
        /*00e0*/                   EXIT ;
"""


def test_sass_count_finds_the_hot_loop_and_its_shortest_path():
    res = sass_count.analyse(SASS)
    assert res["loop"] == (0x20, 0xD0) and res["loop_insns"] == 12
    # the head, the join after the first diamond, the join after the second
    assert res["path_insns"] == 8
    assert res["path"] == {"ldg": 1, "alu": 3, "lds": 1, "ctrl": 3}
    assert res["per_word"]["alu"] == 3 / 32 and res["per_word"]["lds"] == 1 / 32
    lines = sass_count.report(res)
    assert lines == ["hot loop 0x0020-0x00d0: 12 instructions; shortest path 8: "
                     "alu 3, lds 1, ldg 1, ctrl 3, other 0",
                     "per word (32 a turn) on that path: alu 0.094, lds 0.031, ldg 0.031, "
                     "ctrl 0.094, other 0.000"]


def test_sass_count_follows_divergent_fallbacks_and_picks_the_loading_loop(monkeypatch, capsys):
    """A BRA.DIV may fall through; a backward jump from out-of-line code
    that spans more instructions but fewer loads is not the hot loop.
    Through main(), with the build patched to return this text."""
    text = """
        Function : _Z24stream_sums_words_kernelv
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0020*/                   LOP3.LUT R6, R4, 0x3ffc, RZ, 0xc0, !PT ;
        /*0030*/              @P0 BRA 0x80 ;
        /*0040*/                   BRA.DIV UR4, 0x100 ;
        /*0050*/                   SHFL.DOWN PT, R8, R9, 0x10, 0x1f ;
        /*0060*/                   IADD3 R8, R8, R9, RZ ;
        /*0070*/                   ATOMS.ADD RZ, [R10], R8 ;
        /*0080*/                   IADD3 R12, R12, 0x1, RZ ;
        /*0090*/              @P2 BRA 0x10 ;
        /*00a0*/                   EXIT ;
        /*0100*/                   SHFL.DOWN PT, R8, R9, 0x10, 0x1f ;
        /*0110*/                   BRA 0x0 ;
"""
    monkeypatch.setattr(sass_count, "disassemble",
                        lambda source: (text, "ptxas info    : Used 9 registers\n"))
    assert sass_count.main([]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("flagstat_words_kernels.cu: stream_sums_words_kernel")
    assert out[1] == "  ptxas: ptxas info    : Used 9 registers"
    assert out[2] == ("hot loop 0x0010-0x0090: 9 instructions; shortest path 5: "
                      "alu 2, lds 0, ldg 1, ctrl 2, other 0")
    assert len(out) == 4


def test_sass_count_classes_and_errors(monkeypatch, capsys):
    assert [sass_count.classify(op) for op in ("LOP3.LUT", "IMAD.MOV.U32", "LDS.U16", "LDG.E.128",
                                               "BRA", "SHFL.DOWN", "UIADD3", "SEL")] == \
        ["alu", "alu", "lds", "ldg", "ctrl", "other", "other", "alu"]
    with pytest.raises(RuntimeError, match="0 functions"):
        sass_count.analyse(SASS.replace("stream_sums_words_kernel", "other_kernel"))
    with pytest.raises(RuntimeError, match="no loop"):
        sass_count.analyse("Function : stream_sums_words_kernel\n"
                           "        /*0000*/                   EXIT ;\n")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(sass_count.cuda_build, "_nvcc", no_nvcc)
    assert sass_count.main([]) == 1                            # one line, no traceback
    assert capsys.readouterr().err == "sass_count: error: nvcc not found\n"

"""The port's perf_native against the JAX package's on the CPU: the
software-event group, the per-word rows of the native kernels and their
names (the cases of tests/test_native_host.py), the same events opened
by both, the perf object's own build and its failure reported by name,
and instrumented's perf block. The counting cases skip where
perf_event_open is blocked, as the JAX tests do."""
import numpy as np
import pytest

from libflagstats_tpu.bench import perf_native as JP
from libflagstats_tpu_torch.bench import instrumented
from libflagstats_tpu_torch.bench import perf_native as P
from libflagstats_tpu_torch.io import native_lib


@pytest.fixture
def perf():
    if not P.available():
        pytest.skip("perf_event_open blocked on this host")


def test_event_tables_equal_the_jax_packages():
    assert P.HARDWARE_EVENTS == JP.HARDWARE_EVENTS
    assert P.SOFTWARE_EVENTS == JP.SOFTWARE_EVENTS
    assert P.available() == JP.available()
    assert P.hardware_available() == JP.hardware_available()


def test_perf_group_counts_software_events(perf):
    g = P.PerfGroup()
    try:
        assert g.ok
        assert "task_clock_ns" in g.names   # software events always open
        g.start()
        acc = 0
        for i in range(200_000):
            acc += i * i
        res = g.stop()
        assert res["task_clock_ns"] > 10_000   # >10us of counted CPU time
        # a second bracket must reset, not accumulate
        g.start()
        res2 = g.stop()
        assert res2["task_clock_ns"] < res["task_clock_ns"]
    finally:
        g.close()
    assert acc > 0
    assert g.handle == -1


def test_perf_group_opens_the_events_the_jax_group_opens(perf):
    with P.PerfGroup() as g, JP.PerfGroup() as jg:
        assert g.names == jg.names and g.has_hardware == jg.has_hardware


def test_perf_measure_native_kernels(perf):
    rows = P.native_kernel_report(n_words=1 << 18, iters=3)
    assert [r.name for r in rows] == ["lfs_flagstat_u16", "lfs_pospopcnt_u16"]
    jax_rows = JP.native_kernel_report(n_words=1 << 12, iters=1)
    assert [(r.name, r.events, r.counted) for r in rows] == \
        [(r.name, r.events, r.counted) for r in jax_rows]
    for r in rows:
        assert r.counted == P.hardware_available()
        tk = r.min_per_word.get("task_clock_ns")
        # sane per-word on-CPU time: > 0 and well under a microsecond
        assert tk is not None and 0 < tk < 1000
        if r.counted:
            assert 0 < r.min_per_word["cycles"] < 1000
            assert r.ipc and r.ipc > 0
    report = P.format_report(rows)
    assert report.splitlines()[0].split("\t")[:3] == ["kernel", "words", "counted"]
    assert "lfs_flagstat_u16" in report
    if not P.hardware_available():
        assert "no hardware PMU" in report
        assert all(ln.split("\t")[2] == "sw-only" for ln in report.splitlines()[1:3])


def test_measure_takes_fresh_data_and_the_callers_input(perf):
    seen = []

    def kernel(a):
        seen.append(a)

    run = P.measure(kernel, 1000, iters=3, make_input=lambda i: np.full(1000, i, np.uint16))
    assert run.name == "kernel" and run.iters == 3 and run.n_words == 1000
    assert [int(a[0]) for a in seen] == [0, 1, 2]
    assert set(run.min_per_word) == set(run.events) == set(run.overhead)


def test_a_failed_build_is_reported_by_name_and_costs_nothing_else(monkeypatch, tmp_path):
    """A perf object that does not build (here: a source with the
    missing header) leaves available() False, the report naming the
    compiler's error, and the host library loading as before."""
    bad = tmp_path / "perf_events.cpp"
    bad.write_text("#include <linux/no_such_perf_header.h>\n")
    monkeypatch.setattr(native_lib, "PERF_SOURCES", (bad,))
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_lib, "_perf", None)
    monkeypatch.setattr(native_lib, "PERF_BUILD_ERROR", "")
    assert native_lib.load_perf() is None
    assert "no_such_perf_header.h" in native_lib.PERF_BUILD_ERROR
    assert not P.available() and not P.hardware_available()
    assert P.measure(lambda a: None, 100) is None
    assert P.native_kernel_report(n_words=1 << 10, iters=1) == []
    reason = P.unavailable_reason()
    assert reason.startswith("the perf object did not build (") and "no_such_perf_header" in reason
    assert P.format_report([]) == f"perf_event unavailable: {reason}"
    assert native_lib.load() is not None       # the codecs' library is untouched
    lines = instrumented.run_all(n=1 << 12, iters=1, device="cpu", with_roofline=False)
    assert lines[-2:] == ["", f"perf_event unavailable: {reason}"]
    assert all(ln.endswith("\tok") for ln in instrumented.rows(lines))


def test_blocked_syscall_says_so(monkeypatch):
    """perf_event_open opening no event (a seccomp'd container): the
    rows are empty and the report says why."""
    lib = native_lib.load_perf()
    if lib is None:
        pytest.skip(f"the perf object did not build here: {native_lib.PERF_BUILD_ERROR}")

    class Blocked:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def lfs_perf_open(types, cfgs, n, mask):
            return -2

    monkeypatch.setattr(native_lib, "load_perf", lambda: Blocked())
    assert not P.available()
    assert P.native_kernel_report(n_words=1 << 10, iters=1) == []
    assert P.format_report([]) == ("perf_event unavailable: perf_event_open opened no event "
                                   "(blocked on this host)")


def test_instrumented_perf_block_follows_the_rows():
    lines = instrumented.run_all(n=1 << 12, iters=1, device="cpu", with_roofline=False)
    rows = instrumented.rows(lines)
    assert [r.split("\t")[0] for r in rows] == ["numpy", "native", "torch"]
    block = lines[len(rows) + 2:]
    assert lines[len(rows) + 1] == "" and block
    if P.available():
        assert block[0].startswith("kernel\twords\tcounted\t")
        assert [ln.split("\t")[0] for ln in block[1:3]] == ["lfs_flagstat_u16",
                                                            "lfs_pospopcnt_u16"]
    else:
        assert block == [P.format_report([])]
    no_perf = instrumented.run_all(n=1 << 12, iters=1, device="cpu", with_roofline=False,
                                   with_perf=False)
    assert "" not in no_perf and len(no_perf) == 1 + len(rows)

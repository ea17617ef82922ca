"""The range column readers (io/csrc/flag_columns.cpp, bound by
io/native_lib.py ``load_columns()``): ``bamio.read_bam_flags_byte_range``
and ``samio.read_sam_flags_range`` against the JAX package on the same
seeded files, tolerance 0. Over P = 1..5 ranges and 1, 2 and 4 threads
the range columns concatenate to the JAX package's ``read_bam_flags`` /
``read_sam_flags``; each range's endpoints, its column's counters and
its refusals equal those of the JAX package's fused range walkers
(``flagstat_bam_byte_range``, ``flagstat_sam_range``). The same cases run
once more through a build under AddressSanitizer and
UndefinedBehaviorSanitizer, in a worker process that preloads their
runtimes."""
import ctypes
import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from libflagstats_tpu.io import bamio as jbam
from libflagstats_tpu.io import samio as jsam
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.io import bamio as tbam
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.io import samio as tsam
from libflagstats_tpu_torch.io.codec import shard_block_ranges
from test_torch_multihost_containers_2proc import _broken_bam, _corrupt_last_member

_REPO = str(Path(__file__).resolve().parent.parent)
SAM_MALFORMED = {"not a number": b"r1\tx77\t*\n", "over 16 bits": b"r1\t65536\t*\n",
                 "junk after digits": b"r1\t7 7\t*\n", "empty field": b"r1\t\t*\n"}
BAM_REFUSALS = ["truncated.bam", "not gzip", "bgzf, not BAM", "empty", "plain text.sam"]
SAM_REFUSALS = ["truncated.sam.gz", "corrupt member.sam.gz", "plain text.sam", "gzip.sam.gz",
                *SAM_MALFORMED]


def _bgzf(data: bytes, path, member: int) -> None:
    with open(path, "wb") as fh:
        for off in range(0, len(data), member):
            fh.write(jbam._bgzf_member(data[off:off + member], level=1))
        fh.write(jbam.BGZF_EOF)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded files, written by the JAX package: a realistic BAM whose
    inflated stream (22 MB) is past the 16 MiB a range needs before it
    splits into shards, a minimal BAM of 150,001 records, the broken BAM
    of the legs' test,
    a BGZF SAM of 8,000-byte members, one of 20-byte members (its
    54-byte header spans the first three), and the refusal cases."""
    d = tmp_path_factory.mktemp("columns")
    x = generate_flags(150_001, seed=111, full_range=True)
    f = {"realistic.bam": d / "r.bam", "minimal.bam": d / "m.bam",
         "broken.bam": d / "b.bam", "sam.gz": d / "s.sam.gz", "tiny.sam.gz": d / "t.sam.gz"}
    jbam.write_bam(f["realistic.bam"], x[:60_000], payload="realistic", seed=5, level=1)
    # more records in one range than a shard's first 65,536-word column:
    # the column grows through the parser's on_full hook
    jbam.write_bam(f["minimal.bam"], x, block_bytes=20_000)
    _broken_bam(f["broken.bam"])
    text = d / "s.sam"
    jsam.write_sam(text, x[:30_000])
    _bgzf(text.read_bytes(), f["sam.gz"], 8_000)
    jsam.write_sam(text, x[:300])
    _bgzf(text.read_bytes(), f["tiny.sam.gz"], 20)
    f["sam text"] = text
    # refusals
    good = d / "good.bam"
    jbam.write_bam(good, x[:30_000])
    blob = good.read_bytes()
    for name, data in (("truncated.bam", blob[:len(blob) // 2]), ("not gzip", b"\x00" * 1000),
                       ("bgzf, not BAM", jbam._bgzf_member(b"nope" * 10) + jbam.BGZF_EOF),
                       ("empty", b""), ("plain text.sam", text.read_bytes()),
                       ("gzip.sam.gz", gzip.compress(text.read_bytes(), mtime=0))):
        f[name] = d / f"x{len(f)}"
        f[name].write_bytes(data)
    sam = f["sam.gz"].read_bytes()
    f["truncated.sam.gz"] = d / "tr.sam.gz"
    f["truncated.sam.gz"].write_bytes(sam[:len(sam) // 2])
    f["corrupt member.sam.gz"] = d / "cm.sam.gz"
    f["corrupt member.sam.gz"].write_bytes(_corrupt_last_member(sam))
    for name, body in SAM_MALFORMED.items():
        f[name] = d / f"m{len(f)}.sam.gz"
        _bgzf(b"r0\t1\t*\n" * 3000 + body + b"r1\t2\t*\n", f[name], 8_000)
    return f


def _outcome(fn, *args, **kw):
    """What a range function did: its error's class, "None", or "ok"."""
    try:
        return "None" if fn(*args, **kw) is None else "ok"
    except (ValueError, RuntimeError) as e:
        return type(e).__name__


def _bam_ranges(total: int, parts: int):
    return [(total * p // parts, total * (p + 1) // parts) for p in range(parts)]


@pytest.mark.parametrize("name", ["realistic.bam", "minimal.bam", "broken.bam"])
@pytest.mark.parametrize("threads", [1, 2, 4])
def test_bam_range_columns_equal_jax(files, name, threads):
    path = files[name]
    want = jbam.read_bam_flags(path)
    total = tbam.bam_raw_size(path)
    for parts in range(1, 6):
        cols, chain = [], []
        for lo, hi in _bam_ranges(total, parts):
            got = tbam.read_bam_flags_byte_range(path, lo, hi, threads=threads)
            fused = jbam.flagstat_bam_byte_range(path, lo, hi, threads=threads)
            assert (got is None) == (fused is None), (parts, lo, hi)
            if got is None:
                chain = None
                continue
            col, start, end = got
            assert (start, end) == fused[2:] and col.size == fused[1]
            np.testing.assert_array_equal(flagstat_numpy(col), fused[0])
            cols.append(col)
            if chain is not None:
                chain.append((start, end))
        if chain is None:
            # only the broken BAM breaks: its second half cannot be entered
            assert name == "broken.bam" and parts >= 2
            continue
        assert chain[-1][1] == total and all(a[1] == b[0] for a, b in zip(chain, chain[1:]))
        np.testing.assert_array_equal(np.concatenate(cols), want)
    got = tbam.read_bam_flags_byte_range(path, -1, -1, threads=threads)   # the whole file
    np.testing.assert_array_equal(got[0], want)
    assert got[1:] == jbam.flagstat_bam_byte_range(path, -1, -1, threads=threads)[2:]


def test_the_broken_bams_second_half_cannot_be_entered(files):
    path = files["broken.bam"]
    total = tbam.bam_raw_size(path)
    assert tbam.read_bam_flags_byte_range(path, total // 2, total) is None
    col, start, end = tbam.read_bam_flags_byte_range(path, 0, total // 2)
    assert end == total and col.size == jbam.read_bam_flags(path).size


def _line_starts(text: bytes, raw: int) -> int:
    """Records whose line starts in the first ``raw`` bytes of ``text``."""
    starts = [0] + [i + 1 for i in range(len(text) - 1) if text[i] == 10]
    return sum(1 for s in starts if s < raw and text[s] != ord("@"))


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_sam_member_range_columns_equal_jax(files, threads):
    path = files["sam.gz"]
    want = jsam.read_sam_flags(path)
    n = tsam.bgzf_member_count(path)
    assert n >= 64
    for parts in range(1, 6):
        cols = []
        for a, b in shard_block_ranges(n, parts):
            col = tsam.read_sam_flags_range(path, a, b, threads=threads)
            np.testing.assert_array_equal(flagstat_numpy(col),
                                          jsam.flagstat_sam_range(path, a, b, threads=threads))
            cols.append(col)
        np.testing.assert_array_equal(np.concatenate(cols), want)
    for a in (0, 7, n):   # empty ranges
        assert tsam.read_sam_flags_range(path, a, a, threads=threads).size == 0


def test_sam_edge_ranges(files):
    """A range inside the header holds no line; a range whose last line
    spills into the next member owns that line."""
    tiny = files["tiny.sam.gz"]
    for a, b in ((0, 1), (0, 2), (1, 2)):   # inside the header
        assert tsam.read_sam_flags_range(tiny, a, b).size == 0
        np.testing.assert_array_equal(jsam.flagstat_sam_range(tiny, a, b), np.zeros(32, np.uint64))
    np.testing.assert_array_equal(tsam.read_sam_flags_range(tiny, 0, 3),
                                  jsam.read_sam_flags(tiny)[:1])
    path = files["sam.gz"]
    data = jsam.read_sam_flags(path)
    plain = gzip.decompress(path.read_bytes())
    assert plain[8_000 - 1] != ord("\n")   # member 0 ends inside a line
    col = tsam.read_sam_flags_range(path, 0, 1)
    assert col.size == _line_starts(plain, 8_000)
    np.testing.assert_array_equal(col, data[:col.size])
    np.testing.assert_array_equal(tsam.read_sam_flags_range(path, 1, 2),
                                  data[col.size:_line_starts(plain, 16_000)])


@pytest.mark.parametrize("name", BAM_REFUSALS)
def test_bam_refusals_equal_the_fused_range_walkers(files, name):
    path = files[name]
    total = max(1, os.path.getsize(path) * 4)
    for lo, hi in ((0, total), (total // 2, total), (-1, -1)):
        want = _outcome(jbam.flagstat_bam_byte_range, path, lo, hi, threads=2)
        assert _outcome(tbam.read_bam_flags_byte_range, path, lo, hi, threads=2) == want
        assert want in (("ok",) if name == "empty" else ("ValueError", "None")), want


@pytest.mark.parametrize("name", SAM_REFUSALS)
def test_sam_refusals_equal_the_fused_range_walker(files, name):
    path = files[name]
    for a, b in ((0, 1), (0, 4)):
        want = _outcome(jsam.flagstat_sam_range, path, a, b, threads=2)
        assert _outcome(tsam.read_sam_flags_range, path, a, b, threads=2) == want
    # the whole range refuses, whichever member holds the fault
    assert _outcome(tsam.read_sam_flags_range, path, 0, 1 << 20, threads=2) == "ValueError"


def test_capacity_and_bounds(files):
    """A cap below the column refuses (-5) in both readers; the bound
    helpers are never below the column."""
    lib = native_lib.columns()
    for name in ("realistic.bam", "sam.gz"):
        path = files[name]
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        out = np.empty(4, np.uint16)
        ptr = out.ctypes.data_as(ctypes.c_void_p)
        if name.endswith(".bam"):
            s, e = ctypes.c_int64(), ctypes.c_int64()
            rc = lib.lfs_bam_flags_byte_range(mm.ctypes.data, mm.size, 0, 1 << 40, ptr, 4,
                                              ctypes.byref(s), ctypes.byref(e), 2)
            bound = lib.lfs_bam_flags_range_bound(mm.ctypes.data, mm.size, 0, -1)
            n = jbam.read_bam_flags(path).size
        else:
            rc = lib.lfs_bgzf_sam_flags_range(mm.ctypes.data, mm.size, 0, -1, ptr, 4, 2)
            bound = lib.lfs_bgzf_sam_range_bound(mm.ctypes.data, mm.size, 0, -1)
            n = jsam.read_sam_flags(path).size
        assert rc == -5 and bound >= n, (name, rc, bound, n)


#: the sanitizer worker: binds the port's loader to the instrumented
#: build, runs the cases and writes what each returned
_SAN_WORKER = r'''
import ctypes, json, sys
import numpy as np
from libflagstats_tpu_torch.io import bamio, native_lib, samio
from libflagstats_tpu_torch.io.codec import shard_block_ranges

native_lib._columns = native_lib._bind_columns(ctypes.CDLL(sys.argv[1]))
spec, out = json.loads(sys.argv[2]), sys.argv[3]
files = spec["files"]
cols, outcomes = {}, {}


def outcome(fn, *a, **k):
    try:
        r = fn(*a, **k)
    except ValueError:
        return "ValueError", None
    return ("None", None) if r is None else ("ok", r)


for name in ("realistic.bam", "minimal.bam", "broken.bam"):
    total = bamio.bam_raw_size(files[name])
    for threads in (1, 2):
        for parts in (1, 2, 3):
            for p in range(parts):
                lo, hi = total * p // parts, total * (p + 1) // parts
                key = f"{name} {threads} {parts} {p}"
                outcomes[key], r = outcome(bamio.read_bam_flags_byte_range, files[name], lo, hi,
                                           threads=threads)
                if r is not None:
                    cols[key] = np.array(r[0])
                    outcomes[key] = [outcomes[key], r[1], r[2]]
n = samio.bgzf_member_count(files["sam.gz"])
for threads in (1, 4):
    for parts in (1, 2, 3):
        for p, (a, b) in enumerate(shard_block_ranges(n, parts)):
            cols[f"sam.gz {threads} {parts} {p}"] = samio.read_sam_flags_range(
                files["sam.gz"], a, b, threads=threads)
for b in (1, 2, 3):
    cols[f"tiny.sam.gz 0 {b}"] = samio.read_sam_flags_range(files["tiny.sam.gz"], 0, b)
for name in spec["bam_refusals"]:
    outcomes["bam " + name] = outcome(bamio.read_bam_flags_byte_range, files[name], 0, 1 << 40,
                                      threads=2)[0]
for name in spec["sam_refusals"]:
    outcomes["sam " + name] = outcome(samio.read_sam_flags_range, files[name], 0, 1 << 20,
                                      threads=2)[0]
np.savez(out, **{k.replace(" ", "|"): v for k, v in cols.items()})
with open(out + ".json", "w") as fh:
    json.dump(outcomes, fh)
'''


def test_range_readers_under_address_and_ub_sanitizers(files, tmp_path):
    """flag_columns.cpp built with -fsanitize=address,undefined runs the
    column, edge and refusal cases above with no report, and returns
    what the JAX package's readers and fused range walkers say."""
    so = tmp_path / "columns_san.so"
    cmd = ["g++", "-O0", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
           "-fno-sanitize-recover=undefined", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-DLFS_NO_LIBDEFLATE", *map(str, native_lib.COLUMNS_SOURCES), "-o", str(so), "-lz"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    runtimes = [subprocess.run(["g++", f"-print-file-name=lib{s}.so"], capture_output=True,
                               text=True).stdout.strip() for s in ("asan", "ubsan")]
    env = dict(os.environ, LD_PRELOAD=" ".join(runtimes),
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1")
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    script = tmp_path / "worker.py"
    script.write_text(_SAN_WORKER)
    out = tmp_path / "cols.npz"
    arg = json.dumps({"files": {k: str(v) for k, v in files.items()},
                      "bam_refusals": BAM_REFUSALS, "sam_refusals": SAM_REFUSALS})
    r = subprocess.run([sys.executable, str(script), str(so), arg, str(out)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "Sanitizer" not in r.stderr, r.stderr[-6000:]
    outcomes = json.loads(Path(str(out) + ".json").read_text())
    with np.load(out) as z:
        cols = {k.replace("|", " "): z[k] for k in z.files}
    for name in ("realistic.bam", "minimal.bam", "broken.bam"):
        path = files[name]
        total = tbam.bam_raw_size(path)
        want = jbam.read_bam_flags(path)
        for threads in (1, 2):
            for parts in (1, 2, 3):
                got = []
                for p, (lo, hi) in enumerate(_bam_ranges(total, parts)):
                    key = f"{name} {threads} {parts} {p}"
                    fused = jbam.flagstat_bam_byte_range(path, lo, hi, threads=threads)
                    if fused is None:
                        assert outcomes[key] == "None", key
                        continue
                    assert outcomes[key] == ["ok", *fused[2:]], key
                    got.append(cols[key])
                if name != "broken.bam" or parts == 1:
                    np.testing.assert_array_equal(np.concatenate(got), want)
    want = jsam.read_sam_flags(files["sam.gz"])
    for threads in (1, 4):
        for parts in (1, 2, 3):
            np.testing.assert_array_equal(
                np.concatenate([cols[f"sam.gz {threads} {parts} {p}"] for p in range(parts)]),
                want)
    tiny = jsam.read_sam_flags(files["tiny.sam.gz"])
    assert [cols[f"tiny.sam.gz 0 {b}"].tolist() for b in (1, 2, 3)] == [[], [], tiny[:1].tolist()]
    for name in BAM_REFUSALS:
        want = _outcome(jbam.flagstat_bam_byte_range, files[name], 0, 1 << 40, threads=2)
        assert outcomes["bam " + name] == want, name
    for name in SAM_REFUSALS:
        want = _outcome(jsam.flagstat_sam_range, files[name], 0, 1 << 20, threads=2)
        assert outcomes["sam " + name] == want == "ValueError", name

"""The port's three container legs of parallel/multihost.py for real: two
worker processes join a gloo process group through a file://
rendezvous and count a BGZF SAM by member range, a BAM by inflated-byte
range (one whose shard chain holds, one whose chain breaks so that rank
0 counts the whole file alone) and a CRAM by container range, each on
the card route (each rank's column read, then counted by the card
route's plain version on the CPU) and by the fused host walkers, each
checked against flagstat_numpy; a BGZF SAM and a CRAM corrupt only in
rank 1's range make both ranks raise, neither hang. In this process,
outside any group, the same legs equal the JAX package's
(libflagstats_tpu/parallel/multihost.py), and with no card and no
device every leg raises before it reads. The workers import no jax.
Exact."""
import concurrent.futures as cf
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from libflagstats_tpu.io import bamio as jbam
from libflagstats_tpu.io import cramio as jcram
from libflagstats_tpu.io import samio as jsam
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu.parallel import multihost as jM

from libflagstats_tpu_torch.parallel import multihost as M

_REPO = str(Path(__file__).resolve().parent.parent)
N_WORDS = 300_007

_WORKER = r'''
import json, sys

import numpy as np

from libflagstats_tpu_torch.io import bamio
from libflagstats_tpu_torch.parallel import multihost as M

rdv, rank, files, out = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3]), sys.argv[4]
assert M.initialize(init_method="file://" + rdv, world_size=2, rank=rank, backend="gloo")
fallbacks = []


def counted(name):
    whole = getattr(bamio, name)

    def count(path, *a, **k):
        fallbacks.append([name, str(path)])
        return whole(path, *a, **k)
    setattr(bamio, name, count)


counted("flagstat_bam")     # the fused route's whole-file fallback
counted("read_bam_flags")   # the card route's
legs = {
    "sam_split": M.flagstat_multihost_bgzf_sam(files["sam.gz"], n_threads=4, device="cpu"),
    "sam_one_walker": M.flagstat_multihost_bgzf_sam(files["sam.gz"], n_threads=1,
                                                    device="cpu"),
    "sam_split_native": M.flagstat_multihost_bgzf_sam(files["sam.gz"], n_threads=4,
                                                      impl="native"),
    "sam_one_walker_native": M.flagstat_multihost_bgzf_sam(files["sam.gz"], n_threads=1,
                                                           impl="native"),
    "bam": M.flagstat_multihost_bam(files["bam"], n_threads=2, device="cpu"),
    "bam_native": M.flagstat_multihost_bam(files["bam"], n_threads=2, impl="native"),
    "bam_broken": M.flagstat_multihost_bam(files["broken.bam"], n_threads=2, device="cpu"),
    "bam_broken_native": M.flagstat_multihost_bam(files["broken.bam"], n_threads=2,
                                                  impl="native"),
    "cram_gzip": M.flagstat_multihost_cram(files["gzip.cram"], n_threads=2, device="cpu"),
    "cram_rans": M.flagstat_multihost_cram(files["rans.cram"], n_threads=2, device="cpu"),
    "cram_gzip_native": M.flagstat_multihost_cram(files["gzip.cram"], n_threads=2,
                                                  impl="native"),
    "cram_rans_native": M.flagstat_multihost_cram(files["rans.cram"], n_threads=2,
                                                  impl="native"),
}
# a file corrupt only in rank 1's range: every rank raises, none hangs
errors = {}
for leg, name, kw in (("bgzf_sam", "bad.sam.gz", {"device": "cpu"}),
                      ("bgzf_sam", "bad.sam.gz", {"impl": "native"}),
                      ("cram", "bad.cram", {"device": "cpu"}),
                      ("cram", "bad.cram", {"impl": "native"})):
    try:
        getattr(M, "flagstat_multihost_" + leg)(files[name], n_threads=2, **kw)
    except ValueError as e:
        errors[f"{leg} {kw}"] = str(e)
assert len(errors) == 4, errors
with open(out + ".errors.json", "w") as fh:
    json.dump(errors, fh)
# only rank 0 counts a file whose chain broke, and only that file, on
# the route the leg was asked for
broken = files["broken.bam"]
assert fallbacks == ([["read_bam_flags", broken], ["flagstat_bam", broken]] if rank == 0
                     else []), fallbacks
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "libflagstats_tpu"))
assert not bad, bad
np.savez(out, **{k: v.astype(np.int64) for k, v in legs.items()})
import torch.distributed as dist
dist.destroy_process_group()
'''


def _broken_bam(path, n_small: int = 2_000, l_seq: int = 400_000) -> np.ndarray:
    """A BAM of ``n_small`` minimal records and one last record whose
    400 kb of zero SEQ/QUAL bytes span the middle of the inflated stream
    to its end: the second of two byte ranges holds no record boundary,
    so its resync fails and the shard chain breaks. Returns its FLAGs."""
    flags = generate_flags(n_small + 1, seed=64, full_range=True)
    name = b"r\x00"

    def record(flag: int, seq: int) -> bytes:
        body = (struct.pack("<iiBBHHH", -1, -1, len(name), 0, 4680, 0, flag)
                + struct.pack("<iiii", seq, -1, -1, 0) + name
                + b"\x00" * ((seq + 1) // 2 + seq))
        return struct.pack("<i", len(body)) + body

    payload = (b"BAM\x01" + struct.pack("<ii", 0, 0)
               + b"".join(record(int(f), 0) for f in flags[:-1]) + record(int(flags[-1]), l_seq))
    with open(path, "wb") as fh:
        for off in range(0, len(payload), 60_000):
            fh.write(jbam._bgzf_member(payload[off:off + 60_000], level=1))
        fh.write(jbam.BGZF_EOF)
    return flags


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each container, written by the JAX package, and its FLAG column."""
    d = tmp_path_factory.mktemp("legs")
    x = generate_flags(N_WORDS, seed=63, full_range=True)
    f = {name: d / f"mh.{name}" for name in ("sam.gz", "bam", "broken.bam", "gzip.cram",
                                             "rans.cram")}
    text = d / "mh.sam"
    jsam.write_sam(text, x)
    data = text.read_bytes()
    with open(f["sam.gz"], "wb") as fh:       # ~1,100 members: enough for the split
        for off in range(0, len(data), 8_000):
            fh.write(jbam._bgzf_member(data[off:off + 8_000], level=1))
        fh.write(jbam.BGZF_EOF)
    jbam.write_bam(f["bam"], x, level=1, block_bytes=30_000)
    # five containers: an uneven 3/2 split over two ranks
    jcram.write_cram(f["gzip.cram"], x, records_per_container=61_000, method=jcram.GZIP)
    jcram.write_cram(f["rans.cram"], x, records_per_container=61_000, method=jcram.RANS)
    words = dict.fromkeys(f, x)
    words["broken.bam"] = _broken_bam(f["broken.bam"])
    f["bad.sam.gz"], f["bad.cram"] = d / "bad.sam.gz", d / "bad.cram"
    f["bad.sam.gz"].write_bytes(_corrupt_last_member(f["sam.gz"].read_bytes()))
    cram = bytearray(f["gzip.cram"].read_bytes())
    # a bit of the last data container's last block, just before the
    # EOF container: its block CRC fails, its header does not
    cram[-len(jcram.EOF_CONTAINER) - 12] ^= 0x10
    f["bad.cram"].write_bytes(bytes(cram))
    return f, words


def _corrupt_last_member(data: bytes) -> bytes:
    """A BGZF file whose last data member's deflate stream is bad: the
    member chain (headers only) still scans, the inflate of that member
    fails."""
    offs, off = [], 0
    while off < len(data):
        offs.append(off)
        off += struct.unpack_from("<H", data, off + 16)[0] + 1
    out = bytearray(data)
    out[offs[-2] + 18] ^= 0xFF                 # offs[-1] is the EOF member
    return bytes(out)


def test_two_process_container_legs(tmp_path, files):
    paths, words = files
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")   # append
    arg = json.dumps({k: str(v) for k, v in paths.items()})
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "rendezvous"), str(rank), arg,
         str(tmp_path / f"out{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(2)]
    try:
        # drain both pipes at once: waiting on one worker while the other
        # fills its pipe could hang all three processes
        with cf.ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(p.communicate, timeout=300) for p in procs]
            errs = [f.result(timeout=330)[1] for f in futs]
    finally:
        for p in procs:   # never leave a hung worker behind
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(errs)

    file_of = {"sam_split": "sam.gz", "sam_one_walker": "sam.gz", "bam": "bam",
               "bam_broken": "broken.bam", "cram_gzip": "gzip.cram", "cram_rans": "rans.cram",
               "cram_gzip_native": "gzip.cram", "cram_rans_native": "rans.cram",
               "sam_split_native": "sam.gz", "sam_one_walker_native": "sam.gz",
               "bam_native": "bam", "bam_broken_native": "broken.bam"}
    for rank in range(2):
        with np.load(tmp_path / f"out{rank}.npz") as z:
            assert sorted(z.files) == sorted(file_of)
            for leg, name in file_of.items():
                np.testing.assert_array_equal(z[leg], flagstat_numpy(words[name]),
                                              err_msg=f"{leg}, rank {rank}")
    # rank 1 raises its own walker's error, rank 0 names the failed rank
    errors = [json.loads((tmp_path / f"out{rank}.npz.errors.json").read_text())
              for rank in range(2)]
    for key, msg in errors[0].items():
        assert msg.endswith("the walk failed on rank(s) [1]"), (key, msg)
    assert "BGZF SAM range count failed" in errors[1]["bgzf_sam {'impl': 'native'}"]
    assert "BGZF SAM range read failed" in errors[1]["bgzf_sam {'device': 'cpu'}"]
    assert "lfs_cram_flagstat_range failed" in errors[1]["cram {'impl': 'native'}"]
    assert "CRC" in errors[1]["cram {'device': 'cpu'}"], errors[1]


@pytest.mark.parametrize("leg,name,kw", [
    ("bgzf_sam", "sam.gz", {"device": "cpu"}), ("bam", "bam", {"device": "cpu"}),
    ("bam", "broken.bam", {"device": "cpu"}),
    ("cram", "gzip.cram", {"device": "cpu"}), ("cram", "rans.cram", {"device": "cpu"}),
    ("cram", "gzip.cram", {"impl": "native"}), ("cram", "rans.cram", {"impl": "native"}),
    ("bgzf_sam", "sam.gz", {"impl": "native"}), ("bam", "bam", {"impl": "native"}),
    ("bam", "broken.bam", {"impl": "native"})])
def test_single_process_legs_equal_jax(files, monkeypatch, leg, name, kw):
    """Outside a process group each leg is one rank over the whole file:
    it equals the JAX package's leg in its single process, and the
    oracle, by its card route's plain version on the CPU and by the
    fused walkers."""
    paths, words = files
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M._world() == (1, 0)
    path = paths[name]
    got = getattr(M, f"flagstat_multihost_{leg}")(path, n_threads=2, **kw)
    want = getattr(jM, f"flagstat_multihost_{leg}")(path, n_threads=2)
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.uint64))
    np.testing.assert_array_equal(got, flagstat_numpy(words[name]))


def test_the_broken_bam_breaks_the_chain(files):
    """The second half of the broken BAM cannot be entered (rc -9: the
    byte range falls back), while the first half walks to the end of the
    file: the case the legs' fallback exists for."""
    from libflagstats_tpu_torch.io import bamio

    path = files[0]["broken.bam"]
    total = bamio.bam_raw_size(path)
    assert bamio.flagstat_bam_byte_range(path, total // 2, total) is None
    first = bamio.flagstat_bam_byte_range(path, 0, total // 2)
    assert first is not None and first[3] == total


def test_cram_leg_without_a_card_raises_before_reading(files, monkeypatch):
    """With no card and no device the CRAM leg raises before it walks
    the file, as flagstat_cram does."""
    import torch

    from libflagstats_tpu_torch.io import cramio

    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")

    def no_read(*a, **k):
        raise AssertionError("read before the raise")

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(cramio, "_iter_data_containers", no_read)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.flagstat_multihost_cram(files[0]["gzip.cram"])


@pytest.mark.parametrize("leg,module,scan", [("bgzf_sam", "samio", "bgzf_member_count"),
                                             ("bam", "bamio", "bam_raw_size")])
def test_legs_without_a_card_raise_before_reading(files, monkeypatch, leg, module, scan):
    """With no card and no device the BGZF SAM and BAM legs raise before
    they scan the file, as the CRAM leg does; nothing counts on the
    host."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")

    def no_read(*a, **k):
        raise AssertionError("read before the raise")

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(importlib.import_module(f"libflagstats_tpu_torch.io.{module}"), scan,
                        no_read)
    path = files[0]["sam.gz" if leg == "bgzf_sam" else "bam"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(M, f"flagstat_multihost_{leg}")(path)


def test_bam_leg_broken_chain_reads_the_whole_column(files, monkeypatch):
    """The card route's fallback: when the chain breaks, rank 0 reads the
    whole file's column and counts it through flagstat_multihost, never
    through a host walker."""
    from libflagstats_tpu_torch.io import bamio

    paths, words = files
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    reads = []
    whole = bamio.read_bam_flags

    def read(path, *a, **k):
        reads.append(path)
        return whole(path, *a, **k)

    def no_walker(*a, **k):
        raise AssertionError("a host walker counted the card route's fallback")

    monkeypatch.setattr(bamio, "read_bam_flags_byte_range", lambda *a, **k: None)
    monkeypatch.setattr(bamio, "read_bam_flags", read)
    monkeypatch.setattr(bamio, "flagstat_bam", no_walker)
    got = M.flagstat_multihost_bam(paths["broken.bam"], n_threads=2, device="cpu")
    assert reads == [paths["broken.bam"]]
    np.testing.assert_array_equal(got, flagstat_numpy(words["broken.bam"]))

"""The port's multi-process flagstat (parallel/multihost.py) for real:
two worker processes join a gloo process group through a file://
rendezvous and run every leg, each checked against flagstat_numpy and
the JAX package's flagstat_multihost_file(impl="xla") run in this
process; the framed-file leg of the stream's impls also over unequal
block ranges, and with a bad header or a corrupt payload in one rank's
range, where every rank raises and none hangs. The workers import no
jax. The single-process legs run here. Exact."""
import concurrent.futures as cf
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from libflagstats_tpu.io import codec as jC
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu.parallel import multihost as jM

from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.parallel import multihost as M

_REPO = str(Path(__file__).resolve().parent.parent)

_WORKER = r'''
import datetime
import json
import sys

import numpy as np

from libflagstats_tpu_torch.config import CONFIG
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.oracle import generate_flags
from libflagstats_tpu_torch.parallel import multihost as M

rdv, rank, path, out, odd = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
# a short group timeout: a rank left waiting fails on gloo's timeout
# well inside the test's own, not by a kill
assert M.initialize(init_method="file://" + rdv, world_size=2, rank=rank, backend="gloo",
                    timeout=datetime.timedelta(seconds=60))
assert M._world() == (2, rank)
legs = {}

# the framed file sharded by block range, through each device impl's
# plain version and the default device tier on the CPU
for impl in ("cuda", "cuda_words", "cuda_pre", None):
    legs[f"file_{impl}"] = M.flagstat_multihost_file(path, "lz4", impl=impl, device="cpu")

# the stream's impls over unequal block ranges (21 and 20 frames), in
# runs of two frames: several runs a rank
chunk = CONFIG.stream_chunk_words
CONFIG.stream_chunk_words = 2 * 65536
for impl in ("torch", "cuda", "cuda_pre"):
    legs[f"odd_{impl}"] = M.flagstat_multihost_file(odd, "lz4", impl=impl, device="cpu")
CONFIG.stream_chunk_words = chunk

# a bad header or a corrupt payload in rank 1's range: every rank raises,
# and the group stays in step for the collectives below
errors = {}
for fault in ("bad_header", "bad_payload"):
    for impl in ("torch", "cuda", "cuda_pre", "cuda_words", "native"):
        try:
            # native is a host impl: it takes no device
            M.flagstat_multihost_file(odd + "." + fault, "lz4", impl=impl,
                                      device=None if impl == "native" else "cpu")
            errors[f"{fault}_{impl}"] = None
        except (ValueError, RuntimeError) as e:
            errors[f"{fault}_{impl}"] = f"{type(e).__name__}: {e}"
with open(out + ".json", "w") as f:
    json.dump(errors, f)

# equal shards, total_words=None: the true total from an all-reduce
local = generate_flags(250_000, seed=100 + rank, full_range=True)
legs["equal"] = M.flagstat_multihost(local, impl="cuda_words", device="cpu")

# uneven shards with pad_to_words: the pass total from the pre-pad sizes
n3 = 120_000 if rank == 0 else 77_777
legs["uneven"] = M.flagstat_multihost(generate_flags(n3, seed=200 + rank, full_range=True),
                                      impl="torch", pad_to_words=120_000, device="cpu")

# only the 32 counters cross processes
legs["native"] = M.flagstat_multihost_file(path, "lz4", impl="native", n_threads=2)

# uneven shards through the forced device-cap rounds: every rank derives
# the same round count and re-agrees each round's total and largest shard
D.DEVICE_WORD_CAP = 60_000
n5 = 90_000 if rank == 0 else 63_001
legs["capped"] = M.flagstat_multihost(generate_flags(n5, seed=300 + rank, full_range=True),
                                      impl="cuda", device="cpu")
D.DEVICE_WORD_CAP = 0x7FFFFFFF

# a pad below this rank's shard raises before any collective
try:
    M.flagstat_multihost(local, total_words=500_000, pad_to_words=10, device="cpu")
    raise SystemExit("pad_to_words below the shard did not raise")
except ValueError:
    pass

gathered = M._allgather_i64(np.array([rank, 7 * rank + 1]))
assert gathered.tolist() == [[0, 1], [1, 8]], gathered
assert M._global_max(5 - rank) == 5 and M._global_sum(2 ** 40 + rank) == 2 ** 41 + 1

bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "libflagstats_tpu"))
assert not bad, bad
np.savez(out, **{k: v.astype(np.int64) for k, v in legs.items()})
import torch.distributed as dist
dist.destroy_process_group()
'''


def _framed_with(path, dst, i, fault):
    """A copy of a framed file with frame i's header or payload made bad."""
    frames = list(jC.iter_framed(path))
    with open(dst, "wb") as f:
        for k, (raw_len, payload) in enumerate(frames):
            if k == i and fault == "bad_header":
                f.write(struct.pack("<ii", raw_len, -len(payload)))
            else:
                f.write(struct.pack("<ii", raw_len, len(payload)))
            f.write(b"\xff" * len(payload) if k == i and fault == "bad_payload" else payload)


def test_two_process_multihost(tmp_path):
    x = generate_flags(2_000_000, seed=61, full_range=True)
    path = tmp_path / "mh.lz4"
    jC.write_framed(path, x, codec="lz4", level=1)
    x_odd = generate_flags(2_030_001, seed=63, full_range=True)
    odd = tmp_path / "odd.lz4"
    jC.write_framed(odd, x_odd, codec="lz4", level=1, block_bytes=100_000)   # 41 frames
    for fault in ("bad_header", "bad_payload"):
        _framed_with(odd, f"{odd}.{fault}", 30, fault)                      # rank 1's range
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")   # append

    # a file:// rendezvous needs no port, so there is no port race to retry
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "rendezvous"), str(rank), str(path),
         str(tmp_path / f"out{rank}.npz"), str(odd)],
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

    ref = flagstat_numpy(x).astype(np.int64)
    jax_file = jM.flagstat_multihost_file(path, codec="lz4", impl="xla").astype(np.int64)
    np.testing.assert_array_equal(jax_file, ref)
    jax_odd = jM.flagstat_multihost_file(odd, codec="lz4", impl="xla").astype(np.int64)
    np.testing.assert_array_equal(jax_odd, flagstat_numpy(x_odd).astype(np.int64))

    def both(n0, n1, seed):
        return flagstat_numpy(np.concatenate([
            generate_flags(n0, seed=seed, full_range=True),
            generate_flags(n1, seed=seed + 1, full_range=True)])).astype(np.int64)

    want = {"equal": both(250_000, 250_000, 100), "uneven": both(120_000, 77_777, 200),
            "capped": both(90_000, 63_001, 300)}
    for rank in range(2):
        with np.load(tmp_path / f"out{rank}.npz") as z:
            for leg in ("file_cuda", "file_cuda_words", "file_cuda_pre", "file_None", "native"):
                np.testing.assert_array_equal(z[leg], jax_file, err_msg=f"{leg}, rank {rank}")
            for leg, w in want.items():
                np.testing.assert_array_equal(z[leg], w, err_msg=f"{leg}, rank {rank}")
            for impl in ("torch", "cuda", "cuda_pre"):
                np.testing.assert_array_equal(z[f"odd_{impl}"], jax_odd,
                                              err_msg=f"odd_{impl}, rank {rank}")
    # a bad header fails every rank's scan alike; a corrupt payload fails
    # rank 1's decode (its own error: decompress_block's, the range
    # reader's or the fused walker's), and rank 0 names rank 1
    errors = [json.loads((tmp_path / f"out{rank}.npz.json").read_text()) for rank in range(2)]
    own = {"torch": "RuntimeError: lz4 decompress failed",
           "cuda": "RuntimeError: lz4 decompress failed",
           "cuda_pre": "RuntimeError: lz4 decompress failed",
           "cuda_words": "RuntimeError: framed range decode failed",
           "native": f"ValueError: malformed or undecodable framed stream: {odd}.bad_payload"}
    for impl, error in own.items():
        assert errors[0][f"bad_header_{impl}"] == errors[1][f"bad_header_{impl}"] == \
            "ValueError: corrupt frame header (negative length)"
        assert errors[1][f"bad_payload_{impl}"] == error
        assert errors[0][f"bad_payload_{impl}"] == \
            "ValueError: flagstat_multihost_file: the walk failed on rank(s) [1]"


@pytest.mark.parametrize("impl", ["cuda", "cuda_words", "torch"])
def test_single_process_equals_jax(tmp_path, monkeypatch, impl):
    """Outside a process group every collective is the identity: the
    file and column legs equal the JAX package's single-process run."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M.initialize() is False
    assert M._world() == (1, 0)
    x = generate_flags(300_007, seed=62, full_range=True)
    path = tmp_path / "one.lz4"
    jC.write_framed(path, x, codec="lz4", level=1, block_bytes=50_000)
    want = jM.flagstat_multihost_file(path, codec="lz4", impl="xla")
    np.testing.assert_array_equal(M.flagstat_multihost_file(path, "lz4", impl=impl, device="cpu"),
                                  want)
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 100_000)
    np.testing.assert_array_equal(M.flagstat_multihost(x, impl=impl, device="cpu"),
                                  flagstat_numpy(x))
    np.testing.assert_array_equal(M._global_counter_sum(want), want)


def test_initialize_needs_a_backend():
    with pytest.raises(ValueError, match="backend"):
        M.initialize(world_size=2, rank=0)

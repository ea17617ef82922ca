"""Stream checkpoints cross between the packages: a run interrupted on a
truncated copy of a framed file checkpoints, and the other package
resumes it on the whole file, exactly (device paths: kind "sums", with
an epoch roll in flight; native paths: kind "counters"). A checkpoint of
the wrong kind is refused alike."""
import struct

import numpy as np
import pytest

import libflagstats_tpu.io.stream as jS
from libflagstats_tpu.io import codec as jC
from libflagstats_tpu.ops import dispatch as jD
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu_torch.io import stream as tS
from libflagstats_tpu_torch.ops import dispatch as tD
from libflagstats_tpu_torch.ops import kernels as K
from test_torch_stream import engage

GW = K.GROUP_WORDS
CAP = 150_000   # a small DEVICE_WORD_CAP: epochs roll every third chunk


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """6 groups + a tail in one-group blocks, and a copy of the first
    four frames ("the crash point")."""
    d = tmp_path_factory.mktemp("ck")
    x = generate_flags(6 * GW + 1234, seed=91, full_range=True)
    path = d / "full.lz4"
    jC.write_framed(path, x, codec="lz4", level=1, block_bytes=2 * GW)
    part = d / "part.lz4"
    with open(part, "wb") as f:
        for raw_len, payload in list(jC.iter_framed(path))[:4]:
            f.write(struct.pack("<ii", raw_len, len(payload)))
            f.write(payload)
    return path, part, x


def _run(pkg, path, ck, impl, monkeypatch=None):
    if pkg == "jax":
        return jS.flagstat_stream(path, "lz4", impl=impl, chunk_words=GW,
                                  checkpoint=ck)
    kw = {"device": "cpu"} if impl.startswith("cuda") else {}
    return tS.flagstat_stream(path, "lz4", impl=engage(impl, monkeypatch), chunk_words=GW,
                              checkpoint=ck, **kw)


#: "cuda_card": the path where the card decodes the frames, on the CPU
#: (tests/test_torch_stream.py ``engage``)
DEVICE_PAIRS = [("jax", "xla", "port", "cuda_pre"), ("jax", "xla", "port", "torch"),
                ("port", "cuda_pre", "jax", "xla"), ("port", "cuda", "jax", "xla"),
                ("jax", "xla", "port", "cuda_card"), ("port", "cuda_card", "jax", "xla")]


@pytest.mark.parametrize("pair", DEVICE_PAIRS, ids=["-".join(p) for p in DEVICE_PAIRS])
def test_device_checkpoint_resumes_across_packages(tmp_path, monkeypatch, files, pair):
    writer, w_impl, reader, r_impl = pair
    path, part, x = files
    monkeypatch.setattr(jD, "DEVICE_WORD_CAP", CAP)
    monkeypatch.setattr(tD, "DEVICE_WORD_CAP", CAP)
    Ck = {"jax": jS.StreamCheckpoint, "port": tS.StreamCheckpoint}
    ck_path = tmp_path / "ck.npz"
    _run(writer, part, Ck[writer](ck_path, every_blocks=2), w_impl, monkeypatch)
    ck = Ck[reader](ck_path, every_blocks=2)
    assert ck.kind == "sums" and ck.block_index == 4 and ck.n_words == 4 * GW
    assert ck.total.dtype == np.int32 and ck.grand.sum() > 0   # an epoch rolled
    np.testing.assert_array_equal(_run(reader, path, ck, r_impl, monkeypatch),
                                  flagstat_numpy(x))
    assert ck.block_index == 6 and ck.n_words == 6 * GW


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_native_checkpoint_resumes_across_packages(tmp_path, files, writer):
    path, part, x = files
    Ck = {"jax": jS.StreamCheckpoint, "port": tS.StreamCheckpoint}
    reader = "port" if writer == "jax" else "jax"
    _run(writer, part, Ck[writer](tmp_path / "n.npz", every_blocks=1), "native")
    ck = Ck[reader](tmp_path / "n.npz", every_blocks=1)
    assert ck.kind == "counters" and ck.block_index == 4
    np.testing.assert_array_equal(_run(reader, path, ck, "native"), flagstat_numpy(x))
    assert ck.n_words == x.size


@pytest.mark.parametrize("impl", ["torch", "cuda", "cuda_pre"])
def test_native_checkpoint_refused_by_device_path(tmp_path, files, impl):
    path, part, _ = files
    jS.flagstat_stream(part, "lz4", impl="native",
                       checkpoint=jS.StreamCheckpoint(tmp_path / "n.npz", every_blocks=1))
    ck = tS.StreamCheckpoint(tmp_path / "n.npz", every_blocks=1)
    with pytest.raises(ValueError, match="native host path"):
        _run("port", path, ck, impl)
    with pytest.raises(ValueError, match="native host path"):
        _run("jax", path, jS.StreamCheckpoint(tmp_path / "n.npz"), "xla")


def test_sums_checkpoint_refused_by_native_path(tmp_path, files):
    path, part, _ = files
    _run("port", part, tS.StreamCheckpoint(tmp_path / "s.npz", every_blocks=1), "cuda_pre")
    with pytest.raises(ValueError, match="device-path run"):
        _run("port", path, tS.StreamCheckpoint(tmp_path / "s.npz"), "native")


def test_crash_mid_save_restarts_from_zero(tmp_path):
    bare = tmp_path / "run.ck"          # no .npz suffix: saved at the given path
    ck = tS.StreamCheckpoint(bare, every_blocks=1)
    ck.maybe_save(5, np.arange(16, dtype=np.int32), np.arange(16, dtype=np.int32) * 2, 12345)
    assert bare.exists() and not (tmp_path / "run.ck.tmp").exists()
    ck2 = jS.StreamCheckpoint(bare)
    assert ck2.block_index == 5 and ck2.n_words == 12345 and ck2.epoch_words == 12345
    bare.write_bytes(bare.read_bytes()[:100])
    ck3 = tS.StreamCheckpoint(bare)
    assert ck3.block_index == 0 and ck3.n_words == 0

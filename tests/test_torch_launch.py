"""The one launch helper of the port's kernels (``ops/kernels.launch``),
on the CPU over a fake kernel library: each wrapper's native entry gets
the device's ordinal first and the current stream's handle last, a
nonzero return raises naming the entry and the kernel, and ``LAUNCHES``
counts only calls that enqueued a kernel. The argument lists are the
library's one table (``cuda_build.ENTRIES``), and every wrapper reaches
its entry through the helper, with no device guard of its own."""
import inspect

import pytest
import torch

from libflagstats_tpu_torch.ops import cuda_build
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import lz4_decode as Z
from libflagstats_tpu_torch.ops import probe_kernels as P
from libflagstats_tpu_torch.ops import setalgebra as S
from libflagstats_tpu_torch.ops import words_kernels as W
from libflagstats_tpu_torch.parallel import sharded as SH

STREAM = 0x5EED       # the raw stream handle the fake world hands out
DEVICE = 3            # the fake card's ordinal
ERROR = 700           # a cudaError_t (cudaErrorIllegalAddress)

#: every wrapper that launches a kernel: (its native entry, the
#: LAUNCHES key it counts)
WRAPPERS = {
    K.stream_sums_cuda: ("lfs_stream_sums", "flagstat"),
    K.stream_sums_pre_cuda: ("lfs_stream_sums_pre", "pre"),
    K.epilogue_cuda: ("lfs_epilogue", "epilogue"),
    K.flagstat_count: ("lfs_flagstat_count", "flagstat_report"),
    W.stream_sums_words_cuda: ("lfs_stream_sums_words", "words"),
    S.setop_count_cuda: ("lfs_setop_count_cuda", "setop"),
    P.read_xor_cuda: ("lfs_read_xor", "read_xor"),
    P.transpose_xor_cuda: ("lfs_transpose_xor", "transpose_xor"),
    P.transform_xor_pre_cuda: ("lfs_transform_xor", "transform_xor"),
    P.stream_sums_raw_cuda: ("lfs_stream_sums_raw", "raw"),
    P.fold_xor_cuda: ("lfs_fold_xor", "fold_xor"),
    Z.decode_frames: ("lfs_lz4_decode", "lz4_decode"),
    SH._Native.count: ("lfs_sharded_merge", "epilogue"),
}


class FakeLibrary:
    """Entries that record their arguments, check their count against
    ``cuda_build.ENTRIES`` and return ``rc``."""

    def __init__(self):
        self.calls: list[tuple] = []
        self.rc = 0

    def __getattr__(self, entry):
        if entry not in cuda_build.ENTRIES:
            raise AttributeError(entry)

        def call(*args):
            assert len(args) == len(cuda_build.ENTRIES[entry]), (entry, args)
            self.calls.append((entry, args))
            return self.rc
        return call


@pytest.fixture
def lib(monkeypatch):
    fake = FakeLibrary()
    monkeypatch.setattr(cuda_build, "load", lambda: fake)
    monkeypatch.setattr(K, "raw_stream", lambda dev: STREAM if dev.index == DEVICE else None)
    return fake


@pytest.mark.parametrize("wrapper", list(WRAPPERS), ids=lambda f: f.__name__)
def test_launch_passes_the_ordinal_first_and_the_stream_last(lib, wrapper):
    entry, key = WRAPPERS[wrapper]
    assert f'launch("{entry}", ' in inspect.getsource(wrapper)
    dev = torch.device("cuda", DEVICE)
    args = tuple(range(100, 100 + len(cuda_build.ENTRIES[entry]) - 2))
    before = K.LAUNCHES[key]
    K.launch(entry, key, dev, *args)
    assert lib.calls == [(entry, (DEVICE,) + args + (STREAM,))]
    assert K.LAUNCHES[key] == before + 1
    K.launch(entry, key, dev, *args, ran=False)      # an empty input: no kernel
    assert len(lib.calls) == 2 and K.LAUNCHES[key] == before + 1
    lib.rc = ERROR
    with pytest.raises(RuntimeError, match=f"{entry} \\({key}\\) failed: cudaError {ERROR}"):
        K.launch(entry, key, dev, *args)
    assert len(lib.calls) == 3 and K.LAUNCHES[key] == before + 1


@pytest.mark.parametrize("module", [K, W, P, S, Z, SH],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_no_launch_site_keeps_a_device_guard_or_a_stream_object(module):
    source = inspect.getsource(module)
    assert "torch.cuda.device(" not in source and ".cuda_stream" not in source


def test_wave_blocks_reads_the_one_cache_by_key(lib):
    lib.rc = 0
    K.wave_blocks("pre", torch.device("cuda", DEVICE), 24)
    ((entry, (index, key, variant, _)),) = lib.calls
    assert (entry, index, key, variant) == ("lfs_wave_blocks", DEVICE, b"pre", 24)
    lib.rc = ERROR
    with pytest.raises(RuntimeError, match="lfs_wave_blocks"):
        K.wave_blocks("words", torch.device("cuda", DEVICE))


def test_the_table_declares_the_launchers_and_the_queries():
    """Every wrapper's entry is in the one table; beside them only the
    grid query, the kernels' constants and the sharded counts' entry,
    which takes an ordinal and a stream a card (``kernels.native``)."""
    launchers = {entry for entry, _ in WRAPPERS.values()}
    assert set(cuda_build.ENTRIES) - launchers == {"lfs_wave_blocks", "lfs_words_per_block",
                                                   "lfs_words_block_words",
                                                   "lfs_words_flush_bodies",
                                                   "lfs_sharded_counts"}
    assert launchers <= set(cuda_build.ENTRIES)

"""The port's entry points (libflagstats_tpu_torch/graft_entry.py)
against the JAX package's __graft_entry__ on the CPU: entry()'s step on
the same words gives the same counters, the dry run's legs pass over
four CPU shards, a planted wrong merge fails them, and with no card both
raise unless the CPU is asked for."""
import numpy as np
import pytest
import torch

import __graft_entry__ as JG
from libflagstats_tpu_torch import graft_entry as G
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags


def test_entry_step_equals_the_jax_entry_on_the_same_words():
    fn, (x,) = G.entry(device="cpu")
    jfn, (jx,) = JG.entry()
    assert x.device.type == "cpu" and x.numel() == jx.size == 8 * K.GROUP_WORDS == 524_288
    assert np.array_equal(x.numpy().view(np.uint16), jx)
    assert np.array_equal(jx, generate_flags(8 * K.GROUP_WORDS, seed=0))
    got = fn(x)
    assert got.dtype == torch.int64 and got.shape == (32,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(jx), dtype=np.int64))
    np.testing.assert_array_equal(got.numpy(), flagstat_numpy(jx).astype(np.int64))


def test_dryrun_multichip_on_four_cpu_shards(capsys):
    assert G.dryrun_multichip(4, devices=["cpu"] * 4) is None
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(ln.startswith("dryrun_multichip OK on 4 shards (torch tier "
                                                 "on the CPU)") for ln in lines)
    assert lines[0].endswith("3 accumulated steps (uneven tail) match oracle")
    assert f"{4 * 8 * 65536 - 12345} words (uneven tail) match oracle" in lines[1]


def test_dryrun_multichip_checks_every_leg(monkeypatch):
    """One count off in the merged sums of a step fails the accumulated
    leg; one off in the sharded result fails the sharded leg."""
    from libflagstats_tpu_torch.parallel import sharded

    right = sharded.sharded_sums

    def off_by_one(words, devices, impl, report=False):
        total, fail = right(words, devices, impl, report)
        return total + (torch.arange(16) == 6), fail

    monkeypatch.setattr(sharded, "sharded_sums", off_by_one)
    with pytest.raises(AssertionError, match="accumulated steps"):
        G.dryrun_multichip(2, devices=["cpu"] * 2)
    monkeypatch.setattr(sharded, "sharded_sums", right)
    wrong = sharded.flagstat_sharded
    monkeypatch.setattr(sharded, "flagstat_sharded",
                        lambda x, devices=None, impl=None: wrong(x, devices, impl) + 1)
    with pytest.raises(AssertionError, match="torch"):
        G.dryrun_multichip(2, devices=["cpu"] * 2)


def test_dryrun_multichip_shard_devices():
    assert G._shard_devices(3, ["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="2 devices given for 3 shards"):
        G._shard_devices(3, ["cpu"] * 2)
    with pytest.raises(ValueError, match="n_devices"):
        G._shard_devices(0, [])


def test_round_robin_over_the_cards_present(monkeypatch):
    monkeypatch.setattr(G.D, "auto_impl", lambda n, device=None: "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in G._shard_devices(5, None)] == \
        ["cuda:0", "cuda:1", "cuda:0", "cuda:1", "cuda:0"]


@pytest.mark.parametrize("call", [G.entry, lambda: G.dryrun_multichip(4)],
                         ids=["entry", "dryrun_multichip"])
def test_both_raise_with_no_card_and_no_device(call):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")
    before = dict(K.LAUNCHES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert K.LAUNCHES == before

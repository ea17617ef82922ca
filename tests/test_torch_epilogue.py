"""The epilogue of a card count on the CPU: the map that ops/kernels.py
passes by value to the epilogue kernel (ops/csrc/flagstat_epilogue.cu),
applied by its plain twin ``epilogue_plain``, against the plain
``_sums_to_streams`` + ``assemble_counters`` (n up to 2^33) and the JAX
package's ``_sums_to_streams`` + ``assemble_counters`` (within its
int32); a checkpoint's sums seeded into a tally; and the routing of the
one-shot, staged and streamed counts: one count launch a piece, one
epilogue launch a count (a DEVICE_WORD_CAP chunk, a rolled epoch), none
on the plain CPU path. The card path is taken on the CPU by a tally
that believes it is on a card, its epilogue launches going to the
plain twin. Exact (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.ops import xla_ops as jX

import libflagstats_tpu_torch as L
from libflagstats_tpu_torch import flags as F
from libflagstats_tpu_torch.io import codec as C
from libflagstats_tpu_torch.ops import bitslice as B
from libflagstats_tpu_torch.ops import dispatch as D
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import staging as ST
from libflagstats_tpu_torch.ops import words_kernels as W
from libflagstats_tpu_torch.ops.torch_ops import assemble_counters
from libflagstats_tpu_torch.oracle import flagstat_numpy, generate_flags

PIECE = 4096
IMPLS = ("cuda", "cuda_report", "cuda_words", "cuda_pre")
REPORT_ZEROS = [1, 3, 4, 5, 17, 19, 20, 21]


def plain_streams(raw: torch.Tensor, kind: str):
    """(C[k], F[k]) of a kind's raw sums by the plain versions."""
    if kind == "words":
        return W._pass_fail_to_streams(raw)
    return K._sums_to_streams(raw, kind == "flagstat_report")


def random_sums(kind: str, seed: int, high: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, high, K.RAW_STREAMS[kind], dtype=np.int64))


@pytest.mark.parametrize("kind", K.EPILOGUE_KINDS)
@pytest.mark.parametrize("seed", range(4))
def test_map_equals_the_plain_epilogue(kind, seed):
    """Both forms of the twin on random sums below 2^33, n up to 2^33."""
    raw = random_sums(kind, seed, 1 << 33)
    total, fail = plain_streams(raw, kind)
    np.testing.assert_array_equal(K.epilogue_plain(raw, kind), torch.cat([total, fail]))
    rng = np.random.default_rng(100 + seed)
    for n in (0, 1, 1 << 33, int(rng.integers(1 << 33))):
        np.testing.assert_array_equal(K.epilogue_plain(raw, kind, n),
                                      assemble_counters(total, fail, n))


@pytest.mark.parametrize("kind", K.EPILOGUE_KINDS)
@pytest.mark.parametrize("seed", range(3))
def test_map_equals_jax(kind, seed):
    """The JAX package's scatter and assembly (int32, so sums and n
    below 2^30), from the same raw sums."""
    raw = random_sums(kind, 10 + seed, 1 << 30)
    n = int(np.random.default_rng(seed).integers(1 << 30))
    if kind == "words":
        p, f = raw[:15].numpy(), raw[15:].numpy()
        total = jnp.asarray(np.pad(p + f, (0, 1)), jnp.int32)
        fail = jnp.asarray(np.pad(f, (0, 1)), jnp.int32)
    else:
        total, fail = PK._sums_to_streams(jnp.asarray(raw.numpy(), jnp.int32),
                                          kind == "flagstat_report")
    want = np.asarray(jX.assemble_counters(total, fail, n)).astype(np.int64)
    np.testing.assert_array_equal(K.epilogue_plain(raw, kind, n).numpy(), want)
    np.testing.assert_array_equal(K.epilogue_plain(raw, kind).numpy(),
                                  np.concatenate([np.asarray(total), np.asarray(fail)]))


def test_map_reads_every_stream_once_and_nothing_else():
    """Each raw sum feeds exactly one place of (C, F), K6's fail bits
    two (C = pass + fail, F = fail); no index leaves the accumulator."""
    for kind in K.EPILOGUE_KINDS:
        c, c2, f = K.epilogue_map(kind)
        used = [i for i in c + c2 + f if i >= 0]
        assert max(used) < K.RAW_STREAMS[kind] and all(-1 <= i for i in c + c2 + f)
        want = 2 if kind == "words" else 1
        assert all(used.count(i) == (want if kind == "words" and i >= 15 else 1)
                   for i in range(K.RAW_STREAMS[kind]))
        assert f[F.FQCFAIL_OFF] == (F.FQCFAIL_OFF + 15 if kind == "words" else -1)
    with pytest.raises(ValueError):
        K.epilogue_map("pospopcnt")


@pytest.mark.parametrize("impl", ["torch", "cuda", "cuda_report", "cuda_pre", "cuda_words"])
def test_seed_lays_a_checkpoint_out_as_the_accumulator(impl):
    """A checkpoint's (C, F) seeded into a tally reads back as itself,
    but for what the mode does not count: F at the QC-fail bit (the
    JAX xla tier writes it; no counter reads it) and, in report mode,
    the bits outside REPORT_BITS. The counters are those of the sums."""
    kind, report = ("cuda", True) if impl == "cuda_report" else (impl, False)
    rng = np.random.default_rng(7)
    total = rng.integers(0, 1 << 31, 16, dtype=np.int64)
    fail = np.minimum(rng.integers(0, 1 << 31, 16, dtype=np.int64), total)
    total[15] = fail[15] = 0
    t = ST.Tally(kind, "cpu", report)
    t.seed(total, fail)
    got_c, got_f = (s.numpy() for s in t.streams())
    bit_streams = impl in ("cuda", "cuda_report", "cuda_pre")   # no F at the QC-fail bit
    kept = [k for k in range(16) if impl != "cuda_report" or k in B.REPORT_BITS]
    np.testing.assert_array_equal(got_c[kept], total[kept])
    kept_f = [k for k in kept if not (bit_streams and k == F.FQCFAIL_OFF)]
    np.testing.assert_array_equal(got_f[kept_f], fail[kept_f])
    if bit_streams:
        assert got_f[F.FQCFAIL_OFF] == 0
    n = int(total.max()) + 5
    want = assemble_counters(torch.from_numpy(total), torch.from_numpy(fail), n).numpy()
    got = t.counters(n).astype(np.int64)
    idx = list(F.REPORT_COUNTERS) if impl == "cuda_report" else list(range(32))
    np.testing.assert_array_equal(got[idx], want[idx])


@pytest.fixture
def card_path(monkeypatch):
    """Tallies of the kernel impls take their card path on the CPU: the
    kernels' wrappers add into the accumulator in place (their plain
    versions), and each epilogue launch goes to the plain twin, counted
    in LAUNCHES["epilogue"] as the kernel's launch is. Returns the list
    of counts each launched wrapper saw (words, empty ones left out)."""
    seen = []
    init = ST.Tally.__init__

    def card_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.card = self.impl != "torch"

    def epilogue(acc, kind, n=None, out=None, host=None, done=None):
        K.LAUNCHES["epilogue"] += 1
        return K.epilogue_plain(acc, kind, n)

    def counters(acc, kind, n, timer=None):
        return epilogue(acc, kind, n).numpy().astype(np.uint64)

    real = {"cuda": K.stream_sums_cuda, "pre": K.stream_sums_pre_cuda,
            "words": ST.stream_sums_words_cuda}

    def spy(key, size):
        def wrapper(x, *args, **kwargs):
            if size(x):
                seen.append(size(x))
            return real[key](x, *args, **kwargs)
        return wrapper

    monkeypatch.setattr(ST.Tally, "__init__", card_init)
    monkeypatch.setattr(K, "epilogue_cuda", epilogue)
    monkeypatch.setattr(K, "counters_cuda", counters)
    monkeypatch.setattr(K, "stream_sums_cuda", spy("cuda", lambda x: x.numel()))
    monkeypatch.setattr(K, "stream_sums_pre_cuda",
                        spy("pre", lambda t: t.shape[0] * K.GROUP_WORDS))
    monkeypatch.setattr(ST, "stream_sums_words_cuda", spy("words", lambda x: x.numel()))
    monkeypatch.setattr(ST, "STAGE_WORDS", PIECE)
    return seen


def _check(got, want, impl: str) -> None:
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    if impl == "cuda_report":
        idx = list(F.REPORT_COUNTERS)
        np.testing.assert_array_equal(got[idx], want[idx])
        assert not got[REPORT_ZEROS].any()
    else:
        np.testing.assert_array_equal(got, want)


def _step(impl: str) -> int:
    return K.GROUP_WORDS if impl == "cuda_pre" else PIECE


def _launched(fn):
    before = K.LAUNCHES["epilogue"]
    out = fn()
    return out, K.LAUNCHES["epilogue"] - before


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("size", ["0", "1", "piece", "3piece+5"])
def test_staged_count_launches_one_count_a_piece_and_one_epilogue(card_path, impl, size):
    p = _step(impl)
    n = {"0": 0, "1": 1, "piece": p, "3piece+5": 3 * p + 5}[size]
    x = generate_flags(n, seed=n + 61, full_range=True)
    got, epilogues = _launched(lambda: L.flagstats_u16(x, impl=impl, device="cpu"))
    _check(got, flagstat_numpy(x), impl)
    pieces = -(-n // p)
    assert len(card_path) == pieces and sum(card_path) >= n
    assert epilogues == 1


@pytest.mark.parametrize("impl", IMPLS)
def test_plain_path_launches_no_epilogue(monkeypatch, impl):
    """Without the card, the counts end in the plain versions: the
    epilogue's counter stays where it is."""
    monkeypatch.setattr(ST, "STAGE_WORDS", PIECE)
    x = generate_flags(3 * _step(impl) + 5, seed=67, full_range=True)
    got, epilogues = _launched(lambda: L.flagstats_u16(x, impl=impl, device="cpu"))
    _check(got, flagstat_numpy(x), impl)
    assert epilogues == 0


@pytest.mark.parametrize("impl", IMPLS)
def test_device_word_cap_one_epilogue_a_chunk(card_path, monkeypatch, impl):
    """A column held as a CPU tensor past a shrunk DEVICE_WORD_CAP: one
    count and one epilogue a chunk, each chunk's counter 9 its own."""
    cap = 70_001 if impl == "cuda_pre" else 5_003
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", cap)
    x = generate_flags(3 * cap + 77, seed=71, full_range=True)
    chunks = list(D._device_chunks(x))
    got, epilogues = _launched(lambda: L.flagstats_u16(torch.from_numpy(x.view(np.int16)),
                                                       impl=impl, device="cpu"))
    _check(got, flagstat_numpy(x), impl)
    assert epilogues == len(chunks) == 4
    assert len(card_path) == sum(-(-len(c) // _step(impl)) for c in chunks)


@pytest.mark.parametrize("impl", ["cuda", "cuda_pre"])
def test_stream_epochs_one_epilogue_each(card_path, tmp_path, monkeypatch, impl):
    """The stream's runs add into one accumulator; each rolled epoch and
    the final counters take one epilogue launch, and the counts are
    exact."""
    gw = K.GROUP_WORDS
    x = generate_flags(12 * gw + 99, seed=73, full_range=True)
    path = tmp_path / "x.lz4"
    C.write_framed(path, x, codec="lz4", level=1, block_bytes=2 * gw)
    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 3 * gw)   # an epoch of three runs
    got, epilogues = _launched(lambda: L.flagstat_stream(path, "lz4", impl=impl,
                                                         chunk_words=gw, device="cpu"))
    np.testing.assert_array_equal(got, flagstat_numpy(x))
    runs = 13
    assert len(card_path) == runs
    assert epilogues == -(-runs // 3)        # four epochs rolled, the last read back

"""The stream's LZ4 frame decode (``ops/lz4_decode.py``): its plain
version and, on a card, the kernel (ops/csrc/lz4_decode.cu).

The blocks are built by hand from LZ4 sequences, so that each case the
format allows is there for sure: overlapped matches of offset 1-8, the
15 and 255 steps of both length extensions, literal runs past 16 bytes,
a last sequence of literals only, a block that ends on a match, and the
refusals (offset 0, an offset past the output's start, runs past the
input or the output, a cut extension). The plain version walks a frame
table of many such frames at once, with the shifts the stream passes,
and writes what ``codec.decompress_block`` decodes; the pure-Python
decoder of ``codec`` is the oracle of the bytes.

The tests marked ``card`` run on a CUDA card and skip without one
(``python3 -m pytest tests/test_torch_lz4_decode.py -m card
--noconftest``; this file imports no JAX): the kernel writes what the
host's clean-room decoder writes, byte for byte, and the status it
returns (the length decoded, or -1), on the hand-built blocks, on
corrupted and cut copies of real frames, and on LZ4-fast and LZ4-HC c9
frames of a column."""
import ctypes
import struct

import numpy as np
import pytest
import torch

from libflagstats_tpu_torch.io import codec as C
from libflagstats_tpu_torch.io import native_lib
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import lz4_decode as Z
from libflagstats_tpu_torch.oracle import generate_flags


def _ext(n: int) -> bytes:
    """An LZ4 length extension of n: 255s, then the rest."""
    return b"\xff" * (n // 255) + bytes([n % 255])


def lz4_block(seqs, last: bytes | None = b"") -> tuple[bytes, int]:
    """(an LZ4 block, the bytes it decodes to) of ``seqs``, (literals,
    offset, match length) each, then a last sequence of ``last``
    literals (None: the block ends on the last match)."""
    out, raw = bytearray(), 0
    for lit, off, ml in seqs:
        code = ml - 4
        out.append((min(len(lit), 15) << 4) | min(code, 15))
        if len(lit) >= 15:
            out += _ext(len(lit) - 15)
        out += lit
        out += struct.pack("<H", off)
        if code >= 15:
            out += _ext(code - 15)
        raw += len(lit) + ml
    if last is not None:
        out.append(min(len(last), 15) << 4)
        if len(last) >= 15:
            out += _ext(len(last) - 15)
        out += last
        raw += len(last)
    return bytes(out), raw


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


#: name -> (block, raw_len): each decodes to raw_len bytes
GOOD = {
    **{f"overlap_{o}": lz4_block([(_bytes(o, o), o, 4 + 9 * o)], b"z") for o in range(1, 9)},
    "ext_15": lz4_block([(_bytes(15, 1), 15, 19)], _bytes(15, 2)),
    "ext_255": lz4_block([(_bytes(270, 3), 100, 4 + 15 + 255)], _bytes(270, 4)),
    "ext_two_255s": lz4_block([(_bytes(15 + 510 + 3, 5), 7, 4 + 15 + 510)]),
    "literals_17_33_1000": lz4_block([(_bytes(17, 6), 17, 5), (_bytes(33, 7), 40, 6),
                                      (_bytes(1000, 8), 900, 33)], _bytes(20, 9)),
    "ends_on_a_match": lz4_block([(_bytes(8, 10), 8, 12)], None),
    "literals_only": lz4_block([], _bytes(300, 11)),
    "empty": (b"", 0),
    "many_short": lz4_block([(b"ab" if i % 3 == 0 else b"", 2 + i % 5, 4 + i % 7)
                             for i in range(500)], b"xy"),
    "far_and_near": lz4_block([(_bytes(70_000, 12), 65_535, 40), (b"", 1, 300),
                               (b"q", 65_000, 16), (b"", 3, 64)], b"end"),
}
#: name -> block: each decoding refuses
BAD = {
    "offset_0": lz4_block([(_bytes(4, 13), 0, 4)])[0],
    "offset_past_start": lz4_block([(_bytes(4, 14), 5, 4)])[0],
    "cut_literal_ext": bytes([0xF0]) + b"\xff\xff",
    "cut_offset": bytes([0x10]) + b"a" + b"\x01",
    "cut_match_ext": lz4_block([(_bytes(4, 15), 4, 319)], None)[0][:-1],
    "literal_past_input": bytes([0x50]) + b"abc",
}


def all_blocks() -> tuple[list, list, list]:
    """(names, blocks, raw lengths) of GOOD then BAD (64 bytes each)."""
    names = list(GOOD) + list(BAD)
    return (names, [GOOD[n][0] if n in GOOD else BAD[n] for n in names],
            [GOOD[n][1] if n in GOOD else 64 for n in names])


def frame_table(blocks, raws, gap: int = 3):
    """(comp, table, out bytes) of ``blocks`` laid out as the stream lays
    them: each after an 8-byte header and ``gap`` stray bytes."""
    comp, rows, out = bytearray(), [], 0
    for block, raw in zip(blocks, raws):
        comp += b"\x00" * (8 + gap)
        rows.append((len(comp), len(block), out, raw))
        comp += block
        out += raw
    return (torch.frombuffer(bytearray(comp) or bytearray(1), dtype=torch.uint8),
            torch.tensor(rows, dtype=torch.int64).reshape(-1, 4), out)


def test_the_blocks_are_what_they_say():
    for name, (block, raw) in GOOD.items():
        assert len(C._lz4_decompress_py(block, raw)) == raw, name
    for name, block in BAD.items():
        with pytest.raises(ValueError):
            C._lz4_decompress_py(block, 64)


@pytest.mark.parametrize("shifts", [(0, 0), (5, 6)])
def test_plain_walks_the_table_as_decompress_block(shifts):
    """All the good and bad blocks in one table, decoded from ``first``
    with the stream's shifts: each good frame's bytes and raw length, -1
    for each bad one, and nothing written outside the frames decoded."""
    names, blocks, raws = all_blocks()
    comp, table, total = frame_table(blocks, raws)
    comp_shift, out_shift = shifts
    table[:, Z.SRC] += comp_shift
    table[:, Z.OUT] += out_shift
    first = 2
    out = torch.full((total - raws[0] - raws[1],), 0xA5, dtype=torch.uint8)
    status = torch.full((len(names),), 7, dtype=torch.int32)
    before = dict(K.LAUNCHES)
    Z.decode_frames(comp, table, first, len(names) - first, out,
                    status, comp_shift, out_shift + raws[0] + raws[1])
    assert K.LAUNCHES == before                  # the plain version is no launch
    assert status[:first].tolist() == [7, 7]
    pos = 0
    for name, block, raw, got in zip(names[first:], blocks[first:], raws[first:],
                                     status[first:].tolist()):
        part = out[pos:pos + raw].numpy().tobytes()
        if name in GOOD:
            assert got == raw, name
            assert part == C.decompress_block(block, raw, "lz4") == \
                C._lz4_decompress_py(block, raw), name
        else:
            assert got == -1 and part == b"\xa5" * raw, name
        pos += raw


def test_plain_takes_a_short_block_as_a_failure():
    """A well-formed block that decodes short of its raw length: the
    plain version gives -1 (the kernel its shorter length); either is
    not the raw length, which the stream checks."""
    block, raw = GOOD["ext_15"]
    comp, table, _ = frame_table([block], [raw + 2])
    out = torch.zeros(raw + 2, dtype=torch.uint8)
    status = torch.zeros(1, dtype=torch.int32)
    Z.decode_frames(comp, table, 0, 1, out, status)
    assert status.tolist() == [-1]


def test_the_wrapper_checks_what_it_is_given():
    comp, table, total = frame_table([GOOD["ext_15"][0]], [GOOD["ext_15"][1]])
    out = torch.zeros(total, dtype=torch.uint8)
    status = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        Z.decode_frames(comp.view(torch.int8), table, 0, 1, out, status)
    with pytest.raises(ValueError, match="table"):
        Z.decode_frames(comp, table.to(torch.int32), 0, 1, out, status)
    with pytest.raises(ValueError, match="outside"):
        Z.decode_frames(comp, table, 0, 2, out, status)
    with pytest.raises(ValueError, match="int32"):
        Z.decode_frames(comp, table, 0, 1, out, status.to(torch.int64))
    Z.decode_frames(comp, table, 1, 0, out, status)    # no frames: nothing
    assert status.tolist() == [0]


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with python3 -m pytest "
                    "tests/test_torch_lz4_decode.py -m card --noconftest")
    return torch.device("cuda", torch.cuda.current_device())


def _own(block: bytes, cap: int) -> tuple[int, bytes]:
    """The host's clean-room decoder: (its return, the bytes it wrote)."""
    lib = native_lib.load()
    assert lib is not None, native_lib.BUILD_ERROR
    dst = ctypes.create_string_buffer(max(cap, 1))
    r = lib.lfs_lz4_decompress_own(block, len(block), dst, cap)
    return r, dst.raw[:max(r, 0)]


def card_decode(blocks, raws, dev, first: int = 0):
    """(statuses, each frame's bytes) of the kernel over ``blocks``."""
    comp, table, total = frame_table(blocks, raws)
    out = torch.full((max(total, 1),), 0x5A, dtype=torch.uint8, device=dev)
    status = torch.full((len(blocks),), -7, dtype=torch.int32, device=dev)
    before = K.LAUNCHES["lz4_decode"]
    Z.decode_frames(comp.to(dev), table.to(dev), first, len(blocks) - first, out, status)
    torch.cuda.synchronize(dev)
    assert K.LAUNCHES["lz4_decode"] == before + int(len(blocks) > first)
    out = out.cpu().numpy().tobytes()
    starts = np.concatenate([[0], np.cumsum(raws)])
    return status.cpu().tolist(), [out[a:b] for a, b in zip(starts[:-1], starts[1:])]


def check_card_as_host(blocks, raws, dev):
    status, parts = card_decode(blocks, raws, dev)
    for i, (block, raw) in enumerate(zip(blocks, raws)):
        r, wrote = _own(block, raw)
        assert status[i] == r, (i, status[i], r)
        if r >= 0:
            assert parts[i][:r] == wrote, i
        if r == raw:
            assert parts[i] == C.decompress_block(block, raw, "lz4"), i


@pytest.mark.card
def test_card_hand_built_blocks_as_the_host(cuda):
    _, blocks, raws = all_blocks()
    check_card_as_host(blocks, raws, cuda)
    # a cap one byte short of each good block: refused where the host refuses
    check_card_as_host(blocks[:len(GOOD)], [max(r - 1, 0) for r in raws[:len(GOOD)]], cuda)


@pytest.mark.card
@pytest.mark.parametrize("level", [1, -1, 9])
def test_card_frames_of_a_column_as_the_host(cuda, level, tmp_path):
    """LZ4-fast a1 and a2 and LZ4-HC c9 frames of full-range and
    flags-like columns, then the same frames corrupted and cut: the
    kernel's bytes and statuses are the host decoder's."""
    blocks, raws = [], []
    for n, full in ((300_001, True), (1_500_000, False)):
        x = generate_flags(n, seed=n % 1000 + level + 10, full_range=full)
        path = tmp_path / f"c{n}.lz4"
        C.write_framed(path, x, "lz4", level=level)
        for raw, payload in C.iter_framed(path):
            blocks.append(payload)
            raws.append(raw)
    check_card_as_host(blocks, raws, cuda)
    rng = np.random.default_rng(level + 24)
    bad = []
    for block in blocks:
        b = bytearray(block)
        for _ in range(8):
            b[rng.integers(len(b))] = int(rng.integers(256))
        bad.append(bytes(b))
    cut = [block[:int(rng.integers(1, len(block)))] for block in blocks]
    check_card_as_host(bad + cut, raws + raws, cuda)

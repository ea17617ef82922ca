"""Live knobs of the port, read at their point of use (io/codec.py,
io/stream.py), so editing CONFIG at run time takes effect on the next
call."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    #: framed codec block (reference: flagstats.cpp:136)
    block_bytes: int = 1_024_000
    #: decode pool threads of the stream; 0 = the stream's default (8)
    decode_threads: int = 0
    #: words per device run of the stream's device tiers, at most, in
    #: whole frames (a frame larger than this goes alone): 256 whole
    #: transpose groups (16Mi words; 24 MiB of packed planes), so one
    #: run's kernel time is far above a launch's host cost. chip_smoke
    #: phase 4e times 4Mi and 64Mi beside it (PERF.md §5).
    stream_chunk_words: int = 256 * 65536


CONFIG = Config()

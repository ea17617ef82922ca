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
    #: words per device chunk of the stream's device tiers: 256 whole
    #: transpose groups (16Mi words; 24 MiB of packed planes), so one
    #: chunk's kernel time is far above a launch's host cost. Not yet
    #: measured on the H100.
    stream_chunk_words: int = 256 * 65536


CONFIG = Config()

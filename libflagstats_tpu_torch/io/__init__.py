"""Host IO of the port: the framed block codec (io/codec.py, exported
here as the JAX package's ``io`` exports it), the streaming pipeline
(io/stream.py) and the native library's loader (io/native_lib.py)."""
from .codec import (  # noqa: F401
    BLOCK_BYTES,
    codec_filename,
    compress_block,
    decompress_block,
    iter_framed,
    iter_framed_blocks,
    read_framed,
    write_framed,
)

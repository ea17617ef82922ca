"""Host IO of the port: the framed block codec (io/codec.py), the
container readers (io/samio.py, io/bamio.py, io/cramio.py), the streaming pipeline
(io/stream.py) and the native libraries' loader (io/native_lib.py).
Exports what the JAX package's ``io`` exports, with ``sniff_format`` and
``read_flags_auto`` over every container kind."""
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
from .samio import (  # noqa: F401
    generate_binary,
    generate_text,
    read_binary,
    read_sam_flags,
    read_sam_flags_py,
    text_to_binary,
    write_sam,
)


def sniff_format(path) -> str:
    """Classify a container by content (extension only as tiebreak):

    * gzip/BGZF whose payload starts ``BAM\\x01`` -> ``"bam"``
      (io/bamio.py walker);
    * any other gzip, or plain ``.sam`` / ``.txt`` -> ``"sam"``
      (SAM text / bare FLAG column, io/samio.py);
    * ``CRAM`` magic -> ``"cram"`` (CRAM 3.0 FLAG-series subset,
      io/cramio.py);
    * ``.lz4`` / ``.zst`` -> ``"framed-lz4"`` / ``"framed-zstd"``
      (the reference's own container, flagstats.cpp:136-138);
    * anything else -> ``"binary"`` (raw little-endian uint16 column,
      the reference's only input format, reference README.md:56).
    """
    from . import samio

    name = str(path)
    try:
        with open(path, "rb") as fh:
            head = fh.read(4)
    except OSError:
        head = b""
    if head == b"CRAM":
        return "cram"
    if samio.is_gzip(path):
        import gzip
        import zlib

        try:
            with gzip.open(path, "rb") as fh:
                peek = fh.read(4)
        except (OSError, EOFError, zlib.error):
            # gzip magic but not a decodable gzip stream. A raw binary
            # FLAG column can legally start with the word 0x8b1f (bytes
            # 1f 8b) — route it as binary unless the name insists on
            # gzip, in which case fail cleanly.
            if name.endswith(".gz"):
                raise ValueError(
                    f"{name}: gzip magic but undecodable stream — "
                    "corrupt or truncated gzip") from None
            return "binary"
        return "bam" if peek == b"BAM\x01" else "sam"
    if name.endswith(".bam"):
        # a non-gzip .bam is corrupt; the walker raises the right error
        return "bam"
    if name.endswith((".sam", ".txt")):
        return "sam"
    if name.endswith(".lz4"):
        return "framed-lz4"
    if name.endswith(".zst"):
        return "framed-zstd"
    return "binary"


def read_flags_auto(path, threads: int = 0, kind: str | None = None):
    """FLAG column from any supported container (see sniff_format).
    Pass ``kind`` when the format was already sniffed."""
    kind = kind or sniff_format(path)
    if kind == "bam":
        from .bamio import read_bam_flags

        return read_bam_flags(path, threads=threads)
    if kind == "sam":
        from .samio import read_sam_flags

        return read_sam_flags(path, threads=threads)
    if kind == "cram":
        from .cramio import read_cram_flags

        return read_cram_flags(path, threads=threads)
    if kind.startswith("framed-"):
        from .codec import read_framed

        return read_framed(path, kind.removeprefix("framed-"),
                           n_threads=threads)
    from .samio import read_binary

    return read_binary(path)

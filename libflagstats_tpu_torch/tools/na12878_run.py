"""End-to-end NA12878-scale conformance run (BASELINE.json config #4).

The port of tools/na12878_run.py. It rebuilds the 824,541,892-read
NA12878 FLAG column synthetically (datasets.synth_na12878, whose report
provably equals the published flagstat numbers), writes it as the
reference's framed LZ4 stream, counts it through ``flagstat_stream``
(``impl="cuda"`` on the card by default) and checks every reported
value against the published report (reference: README.md:177-196; the
reference times this workload at 0.72 s over LZ4-HC, README.md:35).

``--container bam|sam|sam.gz|cram`` runs the same check through the
container path instead: the port's writers make the file and
``flagstat_file`` counts it (the native reader, then K1 on the card by
default), the `samtools flagstat <file>` workload end to end. ``cram``
carries the FLAG column only (``--payload minimal``).

Run on the card:
  python -m libflagstats_tpu_torch.tools.na12878_run [--scale 1] [--container cram]
``--device cpu`` counts with the torch tier on the CPU; ``--impl native``
with the fused host walkers. It exits 1 on any mismatch, and with one
line when there is no card and neither is asked for. ``--cold`` drops
the page cache first and needs root.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import io as _io
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ..datasets import na12878_report_values, synth_na12878
from ..ops import dispatch as D
from ..report import counters_to_report

#: what a container run writes, by --container
CONTAINERS = ("bam", "sam", "sam.gz", "cram")


def _check_report(counters, scale: int) -> bool:
    """Print the report and whether each published value matches."""
    rep = counters_to_report(counters)
    expected = na12878_report_values(scale_divisor=scale)
    checks = {
        "total": rep.total[0], "supplementary": rep.supplementary[0],
        "mapped": rep.mapped[0],
        "paired_in_sequencing": rep.paired_in_sequencing[0],
        "read1": rep.read1[0], "read2": rep.read2[0],
        "properly_paired": rep.properly_paired[0],
        "both_mapped": rep.both_mapped[0], "singletons": rep.singletons[0],
        "secondary": rep.secondary[0], "duplicates": rep.duplicates[0],
    }
    print(rep.text())
    ok = all(checks[k] == expected[k] for k in checks)
    print(f"[check] published-report match: {ok}")
    return ok


def _io_counters() -> tuple[int, int]:
    """(bytes this process read from storage, major faults) so far: a
    cold run should read about the file's size from disk, a warm one
    about nothing."""
    import resource

    read_bytes = 0
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                if line.startswith("read_bytes:"):
                    read_bytes = int(line.split()[1])
    except OSError:
        pass
    return read_bytes, resource.getrusage(resource.RUSAGE_SELF).ru_majflt


def drop_page_cache() -> bool:
    """Best-effort page-cache drop (the reference clears the cache
    between decompress timings, benchmark/flagstats.cpp:82-88)."""
    try:
        with open("/proc/sys/vm/drop_caches", "w") as fh:
            fh.write("3\n")
        return True
    except OSError as exc:
        print(f"[cold] page-cache drop unavailable ({exc}); "
              "timing with whatever is cached", flush=True)
        return False


def _write_sam_chunk(fh, part, start: int, payload: str, with_header: bool) -> None:
    from ..io import samio

    if with_header:
        fh.write(b"@HD\tVN:1.6\tSO:unsorted\n"
                 b"@PG\tID:lfs\tPN:libflagstats_tpu\n")
    if payload == "realistic":
        fh.write(samio._realistic_sam_chunk(part, start, 0))
    else:
        fh.write("".join(
            f"r{start + i}\t{v}\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
            for i, v in enumerate(part.tolist())).encode())


def _write_sam_gz_streaming(path, arr, payload: str, chunk_records: int = 1 << 20) -> None:
    """BGZF SAM with O(chunk) memory and no whole-file plain text: each
    chunk of SAM text compresses straight to BGZF members (members are
    independent, so they concatenate into one valid BGZF stream)."""
    from ..io.bamio import BGZF_EOF, _bgzf_member

    with open(path, "wb") as fh, cf.ThreadPoolExecutor(4) as pool:
        for start in range(0, arr.size, chunk_records):
            part = arr[start:start + chunk_records]
            buf = _io.BytesIO()
            _write_sam_chunk(buf, part, start, payload, with_header=start == 0)
            data = buf.getbuffer()
            for member in pool.map(lambda o: _bgzf_member(bytes(data[o:o + 60000]), level=1),
                                   range(0, len(data), 60000), chunksize=64):
                fh.write(member)
        fh.write(BGZF_EOF)


def _framed_run(scale, codec, level, wd: Path, impl, threads, chunk_words, keep,
                device) -> dict:
    from ..io import codec as C
    from ..io.stream import flagstat_stream

    # the name carries every knob that changes the bytes
    lvl = "" if codec == "raw" else f"_l{level}"
    stream_path = wd / f"na12878_s{scale}{lvl}.{codec}"
    if stream_path.exists():
        print(f"[gen] reusing {stream_path}", flush=True)
    else:
        t0 = time.perf_counter()
        arr, _ = synth_na12878(scale_divisor=scale, seed=0)
        print(f"[gen] {arr.size:,} words in {time.perf_counter() - t0:.1f}s "
              f"({2 * arr.size / 1e9:.2f} GB)", flush=True)
        t0 = time.perf_counter()
        info = C.write_framed(stream_path, arr, codec=codec, level=level)
        print(f"[compress] {info.n_blocks} blocks, {info.raw_bytes / 1e9:.2f} -> "
              f"{info.compressed_bytes / 1e9:.2f} GB "
              f"({info.raw_bytes / max(info.compressed_bytes, 1):.2f}x) in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        del arr

    def count():
        return flagstat_stream(stream_path, codec=codec, impl=impl, threads=threads,
                               chunk_words=chunk_words, device=device)

    # the first pass builds the kernels and warms the page cache
    # (excluded, like the reference's separate cache-warmup mode,
    # flagstats.cpp:596)
    t0 = time.perf_counter()
    count()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    counters = count()
    t_run = time.perf_counter() - t0
    ok = _check_report(counters, scale)
    n = na12878_report_values(scale_divisor=scale)["total"]
    print(f"[time] first {t_warm:.2f}s; steady run {t_run:.2f}s "
          f"({n / t_run / 1e6:.0f} Mwords/s end-to-end; reference: 0.72s for "
          f"824.5M reads over LZ4-HC)")
    if not keep:
        stream_path.unlink(missing_ok=True)
    return {"ok": ok, "counters": counters, "walls_s": {"first": t_warm, "steady": t_run}}


def _container_run(scale, container, payload, wd: Path, impl, threads, cold, keep,
                   device) -> dict:
    """`samtools flagstat <container>` conformance: make the column,
    write the container, count straight from it."""
    from .. import flagstat_file

    if container == "cram" and payload != "minimal":
        raise ValueError("a cram container carries the FLAG column only (payload=minimal)")
    tag = "_real" if payload == "realistic" else ""
    path = wd / f"na12878_s{scale}{tag}.{container}"
    if path.exists():
        print(f"[gen] reusing {path}", flush=True)
    else:
        t0 = time.perf_counter()
        arr, _ = synth_na12878(scale_divisor=scale, seed=0)
        print(f"[gen] {arr.size:,} words in {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        if container == "bam":
            from ..io.bamio import write_bam

            write_bam(path, arr, level=1, payload=payload)
        elif container == "cram":
            from ..io.cramio import write_cram

            write_cram(path, arr)
        elif container == "sam":
            from ..io.samio import write_sam

            write_sam(path, arr, payload=payload)
        else:
            _write_sam_gz_streaming(path, arr, payload)
        print(f"[container] {path.name}: {path.stat().st_size / 1e9:.2f} GB in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        del arr

    walls = {}
    for label in ("cold" if cold else "first", "warm"):
        if label == "cold":
            drop_page_cache()
        io0, mf0 = _io_counters()
        t0 = time.perf_counter()
        counters = flagstat_file(path, threads=threads, impl=impl, device=device)
        t_run = walls[label] = time.perf_counter() - t0
        io1, mf1 = _io_counters()
        c = np.asarray(counters, dtype=np.uint64)
        n = int(c[9] + c[25])        # pass + fail record totals
        print(f"[time] flagstat({path.name}) [{label}] {t_run:.2f}s "
              f"({n / t_run / 1e6:.0f} Mrec/s end-to-end; samtools published "
              f"30m50s for the full 824.5M-record BAM)", flush=True)
        print(f"[io]   [{label}] disk_read {(io1 - io0) / 1e9:.2f} GB "
              f"({(io1 - io0) / max(t_run, 1e-9) / 1e9:.2f} GB/s), "
              f"major_faults {mf1 - mf0:,}", flush=True)
    ok = _check_report(counters, scale)
    if not keep:
        path.unlink(missing_ok=True)
    return {"ok": ok, "counters": counters, "walls_s": walls}


def run(scale: int = 1, codec: str = "lz4", level: int = 1, workdir=None,
        impl: str | None = None, threads: int = 0, chunk_words: int | None = None,
        container: str | None = None, payload: str = "minimal", cold: bool = False,
        keep: bool = False, device=None) -> dict:
    """The conformance run at ``1/scale`` of NA12878 -> {"ok", "counters",
    "walls_s"}. ``workdir`` (default: ``na12878`` in the temporary
    directory) holds the file; a file already there is reused. With no
    card and no ``device``, a card impl (None or ``"cuda*"``) raises
    before anything is made."""
    if impl is None or impl.startswith("cuda"):
        D.device_impl(device)
    wd = Path(workdir or os.path.join(tempfile.gettempdir(), "na12878"))
    wd.mkdir(parents=True, exist_ok=True)
    if container:
        return _container_run(scale, container, payload, wd, impl, threads, cold, keep,
                              device)
    return _framed_run(scale, codec, level, wd, impl, threads, chunk_words, keep, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="na12878_run")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide the 824M-read dataset by this factor")
    ap.add_argument("--codec", default="lz4", choices=["raw", "lz4", "zstd"])
    ap.add_argument("--level", type=int, default=1)
    ap.add_argument("--workdir", default=None,
                    help="where the file is written (default: na12878 in the temporary "
                         "directory)")
    ap.add_argument("--impl", default=None)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--chunk-words", type=int, default=None,
                    help="device chunk size of the framed stream")
    ap.add_argument("--container", default=None, choices=CONTAINERS,
                    help="count through the container path instead of the framed "
                         "stream (cram: the FLAG-series subset, io/cramio.py; payload "
                         "must be minimal)")
    ap.add_argument("--payload", default="minimal", choices=["minimal", "realistic"],
                    help="container record weight: flags-only records, or 151bp "
                         "HiSeqX-weight SEQ/QUAL/name/aux (the real NA12878 record "
                         "shape, reference README.md:33)")
    ap.add_argument("--cold", action="store_true",
                    help="drop the page cache before the first timed run (reference "
                         "clear_cache, benchmark/flagstats.cpp:82-88); needs root")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default=None, help="'cpu' counts with the torch tier")
    args = ap.parse_args(argv)
    try:
        out = run(args.scale, args.codec, args.level, args.workdir, args.impl, args.threads,
                  args.chunk_words, args.container, args.payload, args.cold, args.keep,
                  args.device)
    except (RuntimeError, ValueError) as e:  # no card, or a bad file: one line
        print(f"na12878_run: error: {e}", file=sys.stderr)
        return 1
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""The port's container entry points and host CLI against the JAX
package's on the same seeded files, tolerance 0: ``sniff_format`` gives
the same kind for every container (the raw column that starts with the
gzip magic and the truncated .gz included), ``read_flags_auto`` the same
column, ``flagstat_file`` the same 32 counters as the JAX function and
the oracle, and each of the seven host subcommands prints what the JAX
CLI prints (timing lines on standard error aside). Without a card the
counting entry points raise, or exit 1 with one line, unless the CPU or
a host impl is asked for."""
import gzip
import re
import struct

import numpy as np
import pytest
import torch

import libflagstats_tpu as J
from libflagstats_tpu import cli as jcli
from libflagstats_tpu.io import bamio as jbam
from libflagstats_tpu.io import codec as jC
from libflagstats_tpu.io import cramio as jcram
from libflagstats_tpu.io import samio as jsam
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
import libflagstats_tpu_torch as L
from libflagstats_tpu_torch import cli as tcli
from libflagstats_tpu_torch.io import read_flags_auto, sniff_format
from libflagstats_tpu_torch.io.cramio import read_cram_flags_py
from libflagstats_tpu_torch.ops import kernels as K

KINDS = {"bam": "bam", "realistic.bam": "bam", "sam": "sam", "txt": "sam",
         "sam.gz": "sam", "bgzf.sam.gz": "sam", "cram": "cram", "lz4": "framed-lz4",
         "zst": "framed-zstd", "bin": "binary", "magic.bin": "binary"}


@pytest.fixture(scope="module")
def words():
    return generate_flags(90_001, seed=101, full_range=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory, words):
    """One column in every container kind, written by the JAX package."""
    d = tmp_path_factory.mktemp("containers")
    f = {k: d / f"t.{k}" for k in KINDS}
    jbam.write_bam(f["bam"], words)
    jbam.write_bam(f["realistic.bam"], words, payload="realistic", level=1)
    jsam.write_sam(f["sam"], words)
    f["txt"].write_text("\n".join(map(str, words.tolist())) + "\n")
    text = f["sam"].read_bytes()
    f["sam.gz"].write_bytes(gzip.compress(text, mtime=0))
    with open(f["bgzf.sam.gz"], "wb") as fh:
        for off in range(0, len(text), 60_000):
            fh.write(jbam._bgzf_member(text[off:off + 60_000], level=1))
        fh.write(jbam.BGZF_EOF)
    jcram.write_cram(f["cram"], words, records_per_container=40_000)
    jC.write_framed(f["lz4"], words, "lz4", block_bytes=50_000)
    jC.write_framed(f["zst"], words, "zstd", block_bytes=50_000)
    words.astype("<u2").tofile(f["bin"])
    # a raw column may begin with the word 0x8b1f: the bytes 1f 8b
    np.concatenate([[0x8B1F], words]).astype("<u2").tofile(f["magic.bin"])
    return f


def _words_of(name, words):
    return np.concatenate([[0x8B1F], words]).astype(np.uint16) if name == "magic.bin" else words


@pytest.mark.parametrize("name", sorted(KINDS))
def test_sniff_and_read_equal_jax(files, words, name):
    path = files[name]
    assert sniff_format(path) == J.io.sniff_format(path) == KINDS[name]
    got = read_flags_auto(path, threads=2)
    np.testing.assert_array_equal(got, J.io.read_flags_auto(path, threads=2))
    np.testing.assert_array_equal(got, _words_of(name, words))


@pytest.mark.parametrize("name", sorted(KINDS))
@pytest.mark.parametrize("impl,device", [(None, "cpu"), ("native", None)])
def test_flagstat_file_equals_jax_and_oracle(files, words, name, impl, device):
    path = files[name]
    got = L.flagstat_file(path, threads=2, impl=impl, device=device)
    np.testing.assert_array_equal(got, J.flagstat_file(path, threads=2))
    np.testing.assert_array_equal(got, flagstat_numpy(_words_of(name, words)))


@pytest.mark.parametrize("name", ["bam", "bgzf.sam.gz", "cram", "lz4", "bin"])
@pytest.mark.parametrize("impl", ["cuda", "cuda_pre", "cuda_words", "cuda_report", "numpy"])
def test_kernel_impls_on_the_cpu_take_the_plain_versions(files, words, name, impl):
    """``device="cpu"`` with a kernel impl counts with its plain version
    (no launch); framed files take the stream where it has the impl and
    read-then-count where it has not."""
    before = dict(K.LAUNCHES)
    got = L.flagstat_file(files[name], impl=impl, device="cpu")
    assert K.LAUNCHES == before
    want = flagstat_numpy(words)
    if impl == "cuda_report":
        idx = list(L.flags.REPORT_COUNTERS)
        np.testing.assert_array_equal(got[idx], want[idx])
    else:
        np.testing.assert_array_equal(got, want)


def test_truncated_gzip_and_cram(tmp_path):
    whole = gzip.compress(b"r1\t77\t*\n" * 1000, mtime=0)
    trunc = tmp_path / "trunc.sam.gz"
    trunc.write_bytes(whole[:8])          # inside the gzip header
    for sniff in (J.io.sniff_format, sniff_format):
        with pytest.raises(ValueError, match="undecodable"):
            sniff(trunc)
    trunc.write_bytes(whole[:40])         # a stream that ends early
    assert sniff_format(trunc) == J.io.sniff_format(trunc) == "sam"
    for read in (J.io.read_flags_auto, read_flags_auto):
        with pytest.raises((EOFError, ValueError)):
            read(trunc)
    cram = tmp_path / "x.cram"
    cram.write_bytes(b"CRAM\x03\x00" + b"\x00" * 64)
    assert sniff_format(cram) == J.io.sniff_format(cram) == "cram"
    with pytest.raises(ValueError) as jax_error:
        J.io.read_flags_auto(cram)
    with pytest.raises(ValueError, match=re.escape(str(jax_error.value))):
        read_cram_flags_py(cram)
    # the card route's container column reader refuses it with the fused
    # walker's rc (-2: truncated or corrupt)
    for call in (read_flags_auto, lambda p: L.flagstat_file(p, device="cpu")):
        with pytest.raises(ValueError, match=re.escape("failed (rc=-2)")):
            call(cram)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA-device behaviour")


@pytest.mark.parametrize("name", ["bam", "sam", "bgzf.sam.gz", "cram", "lz4", "bin"])
def test_flagstat_file_raises_without_a_card(files, name):
    _no_cuda()
    before = dict(K.LAUNCHES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.flagstat_file(files[name])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.flagstat_file(files[name], impl="cuda")
    assert K.LAUNCHES == before


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("name", sorted(KINDS))
def test_cli_flagstat_prints_what_jax_prints(files, name, capsys):
    path = str(files[name])
    rc, want, _ = _run(jcli.main, ["flagstat", path], capsys)
    assert rc == 0 and "in total" in want
    for extra in (["--device", "cpu"], ["--impl", "native"], ["--impl", "cuda", "--device", "cpu"]):
        assert _run(tcli.main, ["flagstat", path, "--threads", "2", *extra], capsys)[:2] == (0, want)


@pytest.mark.parametrize("mode,extra,port", [
    ("d", [], []), ("d", ["--stream", "--timers"], []), ("s", [], []), ("s", ["--loop"], []),
    ("r", [], []), ("D", [], []), ("S", [], []), ("R", [], []),
    ("d", [], ["--impl", "cuda_pre"]), ("D", [], ["--impl", "cuda_words"]),
    ("d", ["--stream", "--impl", "native"], []), ("d", ["--stream"], ["--impl", "cuda_pre"])])
def test_cli_decompress_prints_what_jax_prints(files, mode, extra, port, capsys):
    path = str(files["bin" if mode.isupper() else "lz4"])
    rc, want, jerr = _run(jcli.main, ["decompress", path, "--mode", mode, *extra], capsys)
    rc_t, got, err = _run(tcli.main, ["decompress", path, "--mode", mode, *extra, *port,
                                      "--device", "cpu"], capsys)
    assert rc == rc_t == 0 and got == want
    assert ("in total" in got) == (mode not in "rR")
    assert err.splitlines()[0].split(" ")[0] == jerr.splitlines()[0].split(" ")[0]
    if "--timers" in extra:
        assert "pipeline wall-time breakdown" in err


def test_cli_drop_caches_warns_when_it_cannot(files, monkeypatch, capsys):
    monkeypatch.setattr(tcli, "_drop_caches", lambda: False)
    rc, out, err = _run(tcli.main, ["decompress", str(files["lz4"]), "--mode", "r",
                                    "--drop-caches"], capsys)
    assert rc == 0 and out == "" and "could not drop page caches" in err


@pytest.mark.parametrize("args", [["1000", "--seed", "3"], ["777", "--seed", "4", "--full-range"]])
def test_cli_generate_and_utility_equal_jax(tmp_path, args, capsys):
    rc, want, _ = _run(jcli.main, ["generate", *args], capsys)
    assert rc == 0 and _run(tcli.main, ["generate", *args], capsys)[:2] == (0, want)
    outs = []
    for main, tag in ((jcli.main, "j"), (tcli.main, "t")):
        b, txt, u = (tmp_path / f"{tag}.{ext}" for ext in ("bin", "txt", "u"))
        txt.write_text(want)
        assert main(["generate", *args, "--binary", str(b)]) == 0
        rc, _, err = _run(main, ["utility", "--input", str(txt), "-o", str(u)], capsys)
        assert rc == 0 and err == f"wrote {args[0]} words\n"
        outs.append((b.read_bytes(), u.read_bytes()))
    assert outs[0] == outs[1] and outs[0][0] == outs[0][1]


@pytest.mark.parametrize("name", ["bam", "bgzf.sam.gz", "bin", "zst"])
@pytest.mark.parametrize("codec", ["lz4", "zstd", "raw"])
def test_cli_compress_and_bam2flags_equal_jax(files, tmp_path, name, codec, capsys):
    outs = []
    for main, tag in ((jcli.main, "j"), (tcli.main, "t")):
        out, col = tmp_path / f"{tag}.framed", tmp_path / f"{tag}.col"
        assert main(["compress", str(files[name]), "--codec", codec, "--level", "2",
                     "--block-bytes", "30000", "-o", str(out), "--threads", "2"]) == 0
        assert main(["bam2flags", str(files[name]), "-o", str(col)]) == 0
        outs.append((out.read_bytes(), col.read_bytes()))
    assert outs[0] == outs[1]
    np.testing.assert_array_equal(np.frombuffer(outs[1][1], "<u2"),
                                  read_flags_auto(files[name]))


def test_cli_codec_sweep_rows_equal_jax(files, capsys):
    argv = ["codec-sweep", str(files["bin"]), "--lz4-levels", "1", "4", "--lz4-accels", "3",
            "--zstd-levels", "1"]
    rows = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        rc, out, _ = _run(main, argv + extra, capsys)
        assert rc == 0
        # codec, config, compressed MB, ratio: the columns that are no time
        rows.append([line.split("\t")[:4] for line in out.splitlines()])
    assert rows[0] == rows[1]
    assert [r[:2] for r in rows[1][1:]] == [["lz4", "fast_a1"], ["lz4", "HC_c4"],
                                             ["lz4", "fast_a3"], ["zstd", "c1"], ["raw", "-"]]


def _bad_inputs(tmp_path):
    bad = tmp_path / "bad.sam"
    bad.write_text("r1\tnotanumber\t*\n")
    garbled = tmp_path / "garbled.sam.gz"
    garbled.write_bytes(b"\x1f\x8b" + b"\x99" * 64)
    trunc = tmp_path / "trunc.sam.gz"
    trunc.write_bytes(gzip.compress(b"r1\t77\t*\n" * 1000, mtime=0)[:40])
    framed = tmp_path / "odd.lz4"
    framed.write_bytes(struct.pack("<ii", 3, 3) + b"abc")
    garbage = tmp_path / "garbage.lz4"
    jC.write_framed(garbage, np.arange(5000, dtype=np.uint16), "lz4")
    garbage.write_bytes(garbage.read_bytes() + b"\x01\x02\x03")
    cram = tmp_path / "x.cram"
    cram.write_bytes(b"CRAM" + b"\x00" * 30)
    return {"malformed": bad, "missing": tmp_path / "missing.bin", "garbled": garbled,
            "truncated": trunc, "odd raw_len": framed, "trailing garbage": garbage,
            "cram": cram}


@pytest.mark.parametrize("name", ["malformed", "missing", "garbled", "truncated",
                                  "odd raw_len", "trailing garbage", "cram"])
@pytest.mark.parametrize("cmd", ["flagstat", "bam2flags", "compress"])
def test_cli_bad_inputs_exit_1_with_one_line(tmp_path, name, cmd, capsys):
    path = str(_bad_inputs(tmp_path)[name])
    extra = ["--device", "cpu"] if cmd == "flagstat" else []
    rc, out, err = _run(tcli.main, [cmd, path, *extra], capsys)
    assert rc == 1 and "in total" not in out
    assert err.count("\n") == 1 and err.startswith("libflagstats_tpu_torch: error:"), err
    assert _run(jcli.main, [cmd, path], capsys)[0] == 1


@pytest.mark.parametrize("argv", [["flagstat", "{bam}"], ["decompress", "{lz4}", "--mode", "d"],
                                  ["decompress", "{lz4}", "--mode", "d", "--stream"],
                                  ["codec-sweep", "{bin}", "--lz4-levels", "1"]])
def test_cli_counting_subcommands_need_a_card_or_the_cpu(files, argv, capsys):
    _no_cuda()
    argv = [a.format(**{k: files[k] for k in ("bam", "lz4", "bin")}) for a in argv]
    rc, out, err = _run(tcli.main, argv, capsys)
    assert rc == 1 and "in total" not in out
    assert err.count("\n") == 1 and "no CUDA device" in err


def test_cli_help_lists_every_subcommand(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    out = capsys.readouterr().out
    for cmd in ("generate", "utility", "compress", "decompress", "flagstat", "bam2flags",
                "codec-sweep", "inmemory", "instrumented", "kernels"):
        assert cmd in out

"""Real-process scaling of the native host legs of multihost.

The port of tools/multihost_scaling.py: ``flagstat_multihost_file``
(framed LZ4), ``flagstat_multihost_bgzf_sam`` and
``flagstat_multihost_bam``, each with ``impl="native"`` (the fused host
range walkers; the legs' default counts on the card) timed at three
worlds of fresh processes on one host, and the words/s
and efficiency each gives:

  constant silicon: 1 process x 2 threads against 2 processes x 2
      threads (do two coordinated processes get ~2x of one on 2x the
      cores?)
  constant cores:   1 process x 4 threads against 2 processes x 2
      threads (on the same cores, is splitting into processes ~free?)

A world is a set of fresh processes started once for every file: one
process joins no group, two join a gloo group through the port's
``multihost.initialize(..., backend="gloo")`` over a ``file://``
rendezvous (the JAX tool uses ``jax.distributed``, and starts a world
anew for each file; here the seconds a worker takes to start, importing
torch and the package, are paid once a world). The workers import
``libflagstats_tpu_torch`` only. A file's wall in a world is the largest
over its processes of the minimum over ``iters`` runs around the call
itself, start-up excluded (the reference's min-of-runs discipline,
linux/instrumented_benchmark.cpp:107-142); the cross-process sum inside
the call is the barrier, so the wall includes a straggler's wait. Host
only: it takes no device.

The default files are those ``python -m
libflagstats_tpu_torch.tools.na12878_run --keep`` leaves in
``na12878`` under the temporary directory (framed LZ4 at scale 1, the
BGZF SAM at scale 1 with ``--container sam.gz``, the realistic BAM at
scale 4 with ``--container bam --payload realistic``); a missing file
prints ``[skip]``.

Run: python -m libflagstats_tpu_torch.tools.multihost_scaling [--file X.lz4]
         [--sam-gz X.sam.gz] [--bam X.bam] [--iters 3]
Exits 1 when no file was there to time.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: the directory that holds the ``libflagstats_tpu_torch`` package
_ROOT = str(Path(__file__).resolve().parents[2])
#: (processes, threads, label): the three worlds, in the order they run
WORLDS = ((1, 2, "1proc x 2T"), (1, 4, "1proc x 4T"), (2, 2, "2proc x 2T"))
KINDS = ("framed", "bgzf_sam", "bam")

_WORKER = r'''
import json, sys, time
rdv, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
threads, iters, files = int(sys.argv[4]), int(sys.argv[5]), json.loads(sys.argv[6])
from libflagstats_tpu_torch.parallel import multihost
if nproc > 1:
    multihost.initialize(init_method=rdv, world_size=nproc, rank=pid, backend="gloo")

def run(kind, path):
    if kind == "framed":
        return multihost.flagstat_multihost_file(path, codec="lz4", impl="native",
                                                 n_threads=threads)
    if kind == "bam":
        return multihost.flagstat_multihost_bam(path, n_threads=threads, impl="native")
    return multihost.flagstat_multihost_bgzf_sam(path, n_threads=threads, impl="native")

legs = {}
for kind, path in files:
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        counters = run(kind, path)
        best = min(best, time.perf_counter() - t0)
    legs[kind] = {"wall_s": best, "records": int(counters[9]) + int(counters[25])}
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "libflagstats_tpu"))
assert not bad, bad
if nproc > 1:
    import torch.distributed as dist
    dist.destroy_process_group()
print("LEGRESULT " + json.dumps({"pid": pid, "legs": legs}), flush=True)
'''


def default_files() -> dict:
    """{kind: path} of the files ``na12878_run --keep`` leaves in
    ``na12878`` under the temporary directory."""
    base = os.path.join(tempfile.gettempdir(), "na12878")
    return {"framed": os.path.join(base, "na12878_s1_l1.lz4"),
            "bgzf_sam": os.path.join(base, "na12878_s1.sam.gz"),
            "bam": os.path.join(base, "na12878_s4_real.bam")}


def run_worlds(nproc: int, files: dict, threads: int, iters: int,
               timeout: float = 1800) -> dict:
    """One world: ``nproc`` fresh processes counting each of ``files``
    ({kind: path}) in turn with ``threads`` threads each -> {kind:
    {"nproc", "threads", "wall_s", "records", "words_per_s"}}. Raises if
    a worker fails; kills every worker left on the way out."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    order = json.dumps([[kind, str(path)] for kind, path in files.items()])
    with tempfile.TemporaryDirectory() as td:
        rdv = "file://" + os.path.join(td, "rdv")
        procs = [subprocess.Popen([sys.executable, "-c", _WORKER, rdv, str(nproc), str(pid),
                                   str(threads), str(iters), order],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=env)
                 for pid in range(nproc)]
        try:
            reports = []
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    raise RuntimeError(f"worker rc={p.returncode}:\n{err[-4000:]}")
                reports += [json.loads(line[len("LEGRESULT "):])["legs"]
                            for line in out.splitlines() if line.startswith("LEGRESULT ")]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if len(reports) != nproc:
        raise RuntimeError(f"{len(reports)} of {nproc} workers reported")
    world = {}
    for kind in files:
        records = {r[kind]["records"] for r in reports}
        if len(records) != 1:
            raise RuntimeError(f"{kind}: the workers' record totals differ: {sorted(records)}")
        wall = max(r[kind]["wall_s"] for r in reports)
        total = records.pop()   # the global total, the same on every process
        world[kind] = {"nproc": nproc, "threads": threads, "wall_s": wall, "records": total,
                       "words_per_s": total / wall}
    return world


def run_world(nproc: int, kind: str, path: str, threads: int, iters: int,
              timeout: float = 1800) -> dict:
    """One world over one file -> {"nproc", "threads", "wall_s",
    "records", "words_per_s"} (the JAX tool's unit)."""
    return run_worlds(nproc, {kind: path}, threads, iters, timeout)[kind]


def run(files: dict, iters: int = 3) -> dict:
    """Every world over each of ``files`` ({kind: path}; a missing file
    is skipped). Prints one line a file and world, then each file's
    ratios; returns {"rows" (one summary per file timed), "legs" ({kind:
    {label: world}})}."""
    present = {}
    for kind in KINDS:
        path = files.get(kind)
        if path is None:
            continue
        if Path(path).exists():
            present[kind] = path
        else:
            print(f"[skip] {kind}: {path} missing "
                  "(run python -m libflagstats_tpu_torch.tools.na12878_run --keep first)",
                  flush=True)
    legs_by_kind = {kind: {} for kind in present}
    totals = {}
    for nproc, threads, label in WORLDS if present else ():
        t0 = time.perf_counter()
        for kind, r in run_worlds(nproc, present, threads, iters).items():
            legs_by_kind[kind][label] = r
        totals[label] = time.perf_counter() - t0
    rows = []
    for kind, legs in legs_by_kind.items():
        for label, r in legs.items():
            print(f"[{kind}] {label}: wall {r['wall_s']:.2f}s "
                  f"({r['words_per_s'] / 1e6:.0f} Mwords/s; {r['records']} records; launcher "
                  f"overhead excl., world total {totals[label]:.1f}s)", flush=True)
        silicon = legs["2proc x 2T"]["words_per_s"] / legs["1proc x 2T"]["words_per_s"]
        cores = legs["2proc x 2T"]["words_per_s"] / legs["1proc x 4T"]["words_per_s"]
        row = {"kind": kind,
               "constant_silicon_speedup": round(silicon, 3),
               "constant_silicon_efficiency": round(silicon / 2, 3),
               "constant_cores_ratio": round(cores, 3),
               **{label: round(v["wall_s"], 3) for label, v in legs.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return {"rows": rows, "legs": legs_by_kind}


def main(argv=None) -> int:
    files = default_files()
    ap = argparse.ArgumentParser(prog="multihost_scaling")
    ap.add_argument("--file", default=files["framed"])
    ap.add_argument("--sam-gz", default=files["bgzf_sam"])
    ap.add_argument("--bam", default=files["bam"])
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    try:
        out = run({"framed": args.file, "bgzf_sam": args.sam_gz, "bam": args.bam}, args.iters)
    except RuntimeError as e:
        print(f"multihost_scaling: error: {e}", file=sys.stderr)
        return 1
    return 0 if out["rows"] else 1


if __name__ == "__main__":
    sys.exit(main())

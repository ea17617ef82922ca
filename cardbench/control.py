"""The control of ``correct``: the plain reference put in the program's
place, computed in float32 (the step below exact integer counts), at
the cell's own size. Every seed has to come out not correct.

    python3 -m cardbench.control --workload <name> --seeds <n> [<n> ...] [--seconds 2]

Prints one JSON line a seed (its ``correct``, ``attempted`` and checks)
and exits 0 when every seed read not correct, 1 otherwise. The
benchmark's own runs never run it."""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run as run_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cardbench.control", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cardbench.control: no CUDA card", file=sys.stderr)
        return 2
    failed_all = True
    for seed in args.seeds:
        out = run_mod.run(args.workload, seed, args.seconds, False, control=True,
                          log=sys.stderr)
        failed_all &= not out["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"], "checks": out["checks"]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())

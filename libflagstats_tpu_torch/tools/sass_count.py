"""Count the SASS instructions of K6's every-turn path: operations per word.

Compiles K6's source (ops/csrc/flagstat_words_kernels.cu, or another
copy of it given by ``--source``) for sm_90a with the port's nvcc flags
into a cubin, disassembles it with ``cuobjdump -sass`` and finds
``stream_sums_words_kernel``'s hot loop: of the backward branches, the
one whose span holds the most global loads. It prints, by class of
instruction, the loop's shortest path from its head to its back edge,
over forward branches: what a turn of one thread executes when it takes
no branch it can skip (no second-level step, no peel, no flush, no
ragged edge), and that per word at 32 words a turn. Classes: ``alu``
(integer and logic operations, moves and selects: the issue the integer
pipes carry), ``lds`` (shared loads), ``ldg`` (global loads), ``ctrl``
(branches, barriers, reconvergence), ``other``.

Run on the card's machine (needs nvcc and cuobjdump, no card):
  python -m libflagstats_tpu_torch.tools.sass_count [--source X.cu]
Exits 1 with one line when nvcc or cuobjdump is missing or no loop is
found.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

from ..ops import cuda_build

KERNEL = "stream_sums_words_kernel"
WORDS_PER_TURN = 32         # a thread's turn: kVecs = 4 uint4 loads of 8 words
CLASSES = ("alu", "lds", "ldg", "ctrl", "other")
_CTRL = ("BRA", "BSSY", "BSYNC", "WARPSYNC", "BAR", "EXIT", "RET", "NOP", "CALL",
         "JMP", "BREAK", "YIELD")
_OTHER = ("LDC", "ULDC", "S2R", "S2UR", "CS2R", "STS", "STG", "ATOM", "ATOMS", "RED", "SHFL",
          "MEMBAR", "ERRBAR", "DEPBAR", "LDL", "STL", "VOTE", "UMOV", "R2UR", "MATCH")

# /*addr*/  [@P0 ]OPCODE operands ;   and   .L_x_N: labels (naming the next instruction)
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def classify(op: str) -> str:
    """The class of an opcode (its base name, before the first dot)."""
    base = op.split(".")[0]
    if base.startswith("LDS"):
        return "lds"
    if base.startswith("LDG"):
        return "ldg"
    if base in _CTRL:
        return "ctrl"
    if base in _OTHER or base.startswith("U"):
        return "other"
    return "alu"


def parse(sass: str) -> list[tuple]:
    """The instructions of the function whose name holds KERNEL, as
    (address, opcode, branch target or None, may fall through)."""
    parts = re.split(r"^\s*Function : ", sass, flags=re.M)
    found = [p for p in parts[1:] if KERNEL in p.splitlines()[0]]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} functions named like {KERNEL!r} in the SASS")
    rows, labels, pending = [], {}, []
    for line in found[0].splitlines():
        if m := _LABEL.match(line):
            pending.append(m.group(1))
        elif m := _INSN.search(line):
            addr = int(m.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            rows.append((addr, m.group(2), m.group(3), m.group(4).strip()))
    out = []
    for addr, pred, op, args in rows:
        target = None
        if op.split(".")[0] == "BRA" and (m := _TARGET.search(args)):
            target = labels[m.group(1)] if m.group(1) else int(m.group(2), 16)
        # a predicated branch, one on a predicate operand, or BRA.DIV
        # (taken by a divergent warp only) may fall through
        falls = (op.split(".")[0] not in ("BRA", "EXIT", "RET") or bool(pred)
                 or ".DIV" in op or bool(re.match(r"!?U?P[0-9T]\b", args)))
        out.append((addr, op, target, falls))
    return out


def analyse(sass: str) -> dict:
    """The hot loop's span and its shortest path's counts by class."""
    insns = parse(sass)
    index = {i[0]: k for k, i in enumerate(insns)}
    # the hot loop: the backward branch whose span holds the most global
    # loads, and of those the shortest (out-of-line code, such as a
    # divergent shuffle's fallback, may jump back into the loop's tail)
    loops = [(-sum(classify(x[1]) == "ldg" for x in insns[index[t]:k + 1]), k - index[t],
              index[t], k)
             for k, (addr, _, t, _) in enumerate(insns) if t is not None and t <= addr
             and t in index]
    if not loops:
        raise RuntimeError(f"no loop (backward branch) in {KERNEL}")
    *_, head, back = min(loops)
    # fewest instructions from head to back edge over forward edges
    inf = float("inf")
    cost, prev = {head: 1}, {head: None}
    for k in range(head, back):
        if cost.get(k, inf) == inf:
            continue
        _, _, t, falls = insns[k]
        nxt = [k + 1] if falls else []
        if t is not None and k < index.get(t, -1) <= back:
            nxt.append(index[t])
        for s in nxt:
            if cost[k] + 1 < cost.get(s, inf):
                cost[s], prev[s] = cost[k] + 1, k
    if back not in cost:
        raise RuntimeError("the loop's back edge is not reachable from its head")
    path, k = [], back
    while k is not None:
        path.append(k)
        k = prev[k]
    counts = Counter(classify(insns[k][1]) for k in path)
    return {"loop": (insns[head][0], insns[back][0]), "loop_insns": back - head + 1,
            "path_insns": len(path), "path": counts,
            "per_word": {c: counts[c] / WORDS_PER_TURN for c in CLASSES}}


def report(res: dict) -> list[str]:
    c = res["path"]
    return [f"hot loop 0x{res['loop'][0]:04x}-0x{res['loop'][1]:04x}: {res['loop_insns']} "
            f"instructions; shortest path {res['path_insns']}: "
            + ", ".join(f"{k} {c[k]}" for k in CLASSES),
            f"per word ({WORDS_PER_TURN} a turn) on that path: "
            + ", ".join(f"{k} {res['per_word'][k]:.3f}" for k in CLASSES)]


def disassemble(source: Path) -> tuple[str, str]:
    """(SASS text, ptxas report) of ``source`` compiled for sm_90a."""
    nvcc = cuda_build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    if not Path(cuobjdump).exists():
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as work:
        cubin = Path(work) / "k.cubin"
        r = subprocess.run([nvcc, *flags, "-cubin", str(source), "-o", str(cubin)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{r.stderr}")
        d = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True)
        if d.returncode != 0:
            raise RuntimeError(f"cuobjdump failed:\n{d.stderr}")
    return d.stdout, r.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sass_count")
    ap.add_argument("--source", type=Path, default=cuda_build.CSRC / "flagstat_words_kernels.cu",
                    help="a copy of K6's source (with its headers beside it)")
    args = ap.parse_args(argv)
    try:
        sass, ptxas = disassemble(args.source)
        res = analyse(sass)
    except (RuntimeError, OSError) as e:
        print(f"sass_count: error: {e}", file=sys.stderr)
        return 1
    print(f"{args.source}: {KERNEL}")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    for line in report(res):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

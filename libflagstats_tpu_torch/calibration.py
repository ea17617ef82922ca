"""Measured dispatch-crossover calibration file of the port.

The counterpart of ``libflagstats_tpu.calibration``. The port counts on
the card at every size, so its one size tier is that of a call that
asked for the CPU (``device="cpu"``): below ``TORCH_MIN_CPU`` words
``ops.dispatch.auto_impl`` gives ``"numpy"``, from it ``"torch"``
(``POSPOPCNT_TORCH_MIN_CPU`` for ``pospopcnt_u16``). The crossover
depends on the host, so the sweep writes it here and dispatch reads it
at import:

    python -m libflagstats_tpu_torch.tools.crossover_sweep --device cpu --write
    python -m libflagstats_tpu_torch.tools.crossover_sweep --device cpu --pospopcnt --write

File: ``~/.config/libflagstats-tpu-torch/calibration.json`` by default
(override with ``LFS_TORCH_CALIBRATION_FILE``; an empty value disables
it). The JAX package's ``calibration.json`` at the repository root holds
that package's entries and is never read or written here. Schema
(provenance per threshold, so a stale entry describes itself):

    {"version": 1,
     "thresholds": {
       "TORCH_MIN_CPU": {"value": 16384, "date": "2026-10-17",
                         "backend": "cpu",
                         "card": "NVIDIA H100 80GB HBM3, 700.00 W",
                         "dispatch_rtt_ms": 0.2,
                         "tool": "crossover_sweep"}}}

``card`` is what ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` printed on the host that measured. Unknown
names are ignored; a malformed file is reported on standard error and
skipped (the built-in defaults, 0, stand), never a crash at import.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

#: threshold names dispatch accepts from the file: exactly the module
#: constants of ops/dispatch.py that encode measured crossovers
KNOWN_THRESHOLDS = frozenset({"TORCH_MIN_CPU", "POSPOPCNT_TORCH_MIN_CPU"})

_ENV = "LFS_TORCH_CALIBRATION_FILE"


def calibration_path() -> Path | None:
    """$LFS_TORCH_CALIBRATION_FILE, else the user's config path; None
    when disabled (the variable set empty)."""
    env = os.environ.get(_ENV)
    if env is not None:
        return Path(env) if env else None
    return (Path(os.path.expanduser("~")) / ".config" / "libflagstats-tpu-torch"
            / "calibration.json")


def load_thresholds(path: Path | None = None) -> dict[str, int]:
    """{threshold_name: value} from the calibration file: only names in
    KNOWN_THRESHOLDS with usable integer values; {} when the file is
    absent or disabled, and {} with a warning on standard error when it
    is malformed (a silent fallback would make a host think it is
    calibrated)."""
    if path is None:
        path = calibration_path()
    if path is None or not path.is_file():
        return {}
    try:
        with open(path) as fh:
            blob = json.load(fh)
        entries = blob["thresholds"]
        if not isinstance(entries, dict):
            raise ValueError(f"'thresholds' must be a map, got {type(entries).__name__}")
        out = {}
        for name, ent in entries.items():
            if name not in KNOWN_THRESHOLDS:
                continue
            v = ent["value"] if isinstance(ent, dict) else ent
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"threshold {name}: bad value {v!r}")
            out[name] = v
        return out
    except (OSError, KeyError, ValueError, TypeError, AttributeError) as exc:
        # a file of the wrong shape must never break importing
        # ops.dispatch: the built-in defaults are the fallback
        print(f"[libflagstats_tpu_torch] WARNING: calibration file {path} unusable "
              f"({type(exc).__name__}: {exc}); using built-in dispatch thresholds",
              file=sys.stderr)
        return {}


def write_thresholds(thresholds: dict[str, int], provenance: dict,
                     path: Path | None = None) -> Path:
    """Merge measured ``thresholds`` (name -> value) into the calibration
    file, each stamped with ``provenance`` (date, backend, card,
    dispatch_rtt_ms, tool). Entries of other names stay, so the flagstat
    and pospopcnt sweeps accumulate into one file. Written through a
    temporary file and a rename."""
    if path is None:
        path = calibration_path()
    if path is None:
        raise ValueError(f"calibration disabled ({_ENV} is empty)")
    unknown = set(thresholds) - KNOWN_THRESHOLDS
    if unknown:
        raise ValueError(f"unknown threshold names: {sorted(unknown)}")
    blob = {"version": 1, "thresholds": {}}
    if path.is_file():
        try:
            with open(path) as fh:
                old = json.load(fh)
            if isinstance(old.get("thresholds"), dict):
                blob["thresholds"].update(old["thresholds"])
        except (OSError, ValueError, AttributeError) as exc:
            print(f"[calibration] existing {path} unreadable ({exc}); rewriting",
                  file=sys.stderr)
    for name, value in thresholds.items():
        blob["thresholds"][name] = {"value": int(value), **provenance}
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(blob, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path

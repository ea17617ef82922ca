"""BENCHMARK.json and the files it names, found by name: configurations
(their ``file``), traffic mixes (``traffic/<name>.json``), and the
modules ``<kind>/<name>.py``: column kinds (``columns/``), entries
(``entries/``), references (``references/``) and metric readers
(``end_to_end/``, ``layer_metrics/``)."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _named(items: list[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload, configuration, traffic) of the cell ``workload``."""
    w = _named(bench["workloads"], workload, "workload")
    c = _named(bench["configs"], w["config"], "configuration")
    config = json.loads((ROOT / c["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return w, config, traffic


def metrics(bench: dict, section: str, workload: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell ``workload`` reports."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder,
    loaded once."""
    key = f"cardbench.{kind}.{name}"
    if key not in sys.modules:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} module named {name!r}")
        found = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(found)
        sys.modules[key] = mod
        try:
            found.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]

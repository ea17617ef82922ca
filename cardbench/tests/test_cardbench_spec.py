"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from cardbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "-m", "cardbench.run"]
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = [x["name"] for sect in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[sect]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cardbench/") and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_roofline_metrics_are_named_for_their_kernels():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(workload):
    e2e = [m["name"] for m in spec.metrics(BENCH, "end_to_end", workload)]
    layers = spec.metrics(BENCH, "per_layer", workload)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_finds_its_config_traffic_kind_entry_and_reference(workload):
    cell, config, traffic = spec.cell(BENCH, workload)
    assert config["name"] == cell["config"]
    assert config["reduced"] == next(c["reduced"] for c in BENCH["configs"]
                                     if c["name"] == cell["config"])
    assert callable(spec.module("columns", config["column"]["kind"]).make)
    entry = spec.module("entries", traffic["entry"])
    assert callable(entry.make)
    ref = spec.module("references", entry.REFERENCE)
    assert callable(ref.exact) and callable(ref.control)


@pytest.mark.parametrize("section,kind", [("end_to_end", "end_to_end"),
                                          ("per_layer", "layer_metrics")])
def test_each_metric_finds_its_reader(section, kind):
    for m in BENCH[section]:
        assert callable(spec.module(kind, m["name"]).read)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
    with pytest.raises(KeyError):
        spec.module("entries", "no_such_entry")


def test_a_module_is_loaded_once():
    assert spec.module("references", "flagstat") is spec.module("references", "flagstat")

"""BENCHMARK.json: its keys and characters, and every cell's pieces found
by name."""

import importlib
import json
import os
import re

import pytest

from benchmark import generator, session

ROOT = session.ROOT
SPEC = session.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len(SPEC["command"]) <= 32
    assert all(TEXT.match(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert os.path.isdir(os.path.join(ROOT, p))


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda v: v if isinstance(v, str) else
                         v.get("name"))
def test_entry_characters(group, entry):
    assert NAME.match(entry["name"])
    if group == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(entry["source"]) and TEXT.match(entry["why"])
        assert all(NAME.match(k) for k in entry["reduced"])
        assert len(entry["reduced"]) <= 16
        assert entry["file"].startswith(tuple(SPEC["paths"]))
    elif group == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4) and TEXT.match(entry["why"])
    else:
        extra = {"bound"} if group == "end_to_end" else {"layer", "moves"}
        assert set(entry) - {"workloads"} == METRIC_KEYS | extra
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        if group == "end_to_end":
            assert entry["source"] in ("host_clock", "device_trace")
            assert 0.01 <= entry["bound"] <= 0.25
        else:
            assert TEXT.match(entry["layer"])
            assert entry["moves"] in {m["name"] for m in SPEC["end_to_end"]}


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_pieces_found_by_name(workload):
    cell = session.find_cell(SPEC, workload)
    circuit = cell.config["circuit"]
    mod = importlib.import_module(f"benchmark.circuits.{circuit}")
    assert hasattr(mod, "statement") and hasattr(mod, "Circuit")
    ref = importlib.import_module(f"benchmark.reference.{circuit}")
    assert hasattr(ref, "Reference")
    w = {x["name"]: x for x in SPEC["workloads"]}[workload]
    assert generator.load(w["traffic"]) == cell.mix
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(session.metric_module(m["name"]).read)
    for m in cell.per_layer:
        assert m["moves"] in reported


def test_every_config_used_and_roofline_names():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        for w in m.get("workloads", ()):
            assert w in {x["name"] for x in SPEC["workloads"]}


def test_traffic_files_are_data():
    for w in SPEC["workloads"]:
        path = os.path.join(ROOT, "benchmark", "traffic",
                            w["traffic"] + ".json")
        with open(path) as f:
            json.load(f)

"""BENCHMARK.json keeps the benchmark's rules, and every configuration,
traffic mix, workload, driver and metric it names resolves to a file."""

import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_keys_are_the_contract_s():
    assert set(BENCH) == TOP
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_files_resolve():
    assert spec.problems(BENCH) == []


def test_text_fields_are_single_lines():
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert LINE.match(x["why"])
    for c in BENCH["configs"]:
        assert LINE.match(c["source"])
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])
    assert all(LINE.match(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_paths_hold_the_command():
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")


def test_run_length_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def cells_reporting(metric):
    return [w["name"] for w in BENCH["workloads"] if "workloads" not in metric or w["name"] in metric["workloads"]]


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        names = [m["name"] for m in cell["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell["per_layer"], w["name"]


def test_layer_metrics_move_a_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells_reporting(e2e[m["moves"]]), (m["name"], cell)
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values()), layers
    # each kernel roofline has a whole-step share of the peak beside it, moving the same metric
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in x["name"] and x["moves"] == m["moves"] for x in BENCH["per_layer"])


def test_configurations_are_used_and_their_files_say_what_was_cut():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        f = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in f


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_workload_files_hold_limits_for_their_driver(name):
    w = spec.load_json(spec.path_of("workloads", name))
    assert w["name"] == name
    assert w["check"]["limits"] and w["check"]["control"]
    json.dumps(w)

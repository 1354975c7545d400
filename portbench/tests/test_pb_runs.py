"""Whole runs of the harness: every cell, and a cell made of added files
only, in the dry rehearsal on the CPU; the faults a cell can have, and its
control, caught by its check; the controls at the cells' own size on a
card, where there is one."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def run(args, cwd=spec.ROOT, timeout=600):
    out = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=timeout)
    return out


def result(out) -> dict:
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_dry(cell, trace):
    r = result(run(["portbench/run.py", "--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds", "2",
                    "--trace", str(trace), "--dry"]))
    assert r["dry"] and r["correct"], r
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in spec.cell(cell)["end_to_end" if not trace else "per_layer"]}
    assert set(r["metrics"]) <= names | {"setup_s"}
    if not trace:
        assert set(r["metrics"]) == names


def test_a_cell_of_added_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    os.symlink(os.path.join(spec.ROOT, "vietnamese_qa_system_tpu_torch"), root / "vietnamese_qa_system_tpu_torch")
    mix = spec.load_json(spec.path_of("traffic", "queries_bulk"))
    mix["len"] = {"family": "uniform", "min": 16, "max": 32}
    (root / "portbench/traffic/queries_short.json").write_text(json.dumps(mix))
    wl = spec.load_json(spec.path_of("workloads", "search_bulk_b256"))
    wl["name"] = "search_short"
    (root / "portbench/workloads/search_short.json").write_text(json.dumps(wl))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "search_short", "config": "mpnet_base_1m_bf16", "traffic": "queries_short",
                               "chips": 1, "why": "short queries"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "search_bulk_b256" in m.get("workloads", []):
            m["workloads"].append("search_short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = result(run(["portbench/run.py", "--workload", "search_short", "--seed", "3", "--seconds", "2", "--trace",
                    "0", "--dry"], cwd=root))
    assert r["correct"] and "search_qps" in r["metrics"]


def test_no_result_without_the_port(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = run(["portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
              cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = run(["portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0 and not out.stdout.strip()


FAULTS = [("answer_altered", "search_bulk_b256"), ("half_batch", "search_bulk_b256"),
          ("state_unchanged", "ingest_t512"), ("chunk_altered", "ingest_t512"),
          ("token_altered", "gen_closed_64c"), ("token_altered", "gen_poisson_qa")]


@pytest.mark.parametrize("fault,cell", FAULTS)
def test_faults_are_caught(fault, cell):
    r = result(run(["-m", "portbench.tests.faults", fault, cell, "11"]))
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught_at_the_dry_size(cell):
    out = run(["portbench/control.py", "--workload", cell, "--seconds", "2", "--seeds", "21,22", "--dry"])
    assert out.returncode == 0, out.stderr[-3000:]
    limits = spec.cell(cell, dry=True)["workload"]["check"]["limits"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert any(v > limits[k] for k, v in r["control"].items()), r


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught_on_the_card(cell):
    """The control at the cell's own size and window, three seeds: run on a
    machine with the card (``python -m pytest portbench/tests -k card``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    out = run(["portbench/control.py", "--workload", cell, "--seconds", str(BENCH["run_seconds"]),
               "--seeds", "101,102,103"], timeout=3000)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = spec.cell(cell)["workload"]["check"]["limits"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert any(v > limits[k] for k, v in r["control"].items()), r

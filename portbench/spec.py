"""``BENCHMARK.json`` and the files it names, found by name.

- ``configs/<config>.json``: a model configuration as it is run (its
  published sizes at the top level, the deployment's flags under
  ``deployment``, ``reduced`` and ``assumed``);
- ``traffic/<traffic>.json``: the parameters of one traffic mix, read by
  the one generator of ``traffic.py``;
- ``workloads/<cell>.json``: the driver a cell runs and the limits of its
  correctness check;
- ``drivers/<driver>.py``: a class ``Driver`` (see ``harness.py``);
- ``metrics/<metric>.py``: a function ``read(record)`` for one per-layer
  metric.

Each file may carry a ``dry`` object: the overrides that shrink it to the
CPU rehearsal of the tests (``--dry``); a real run never reads it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def path_of(kind: str, name: str) -> str:
    """The file of a configuration, traffic mix, workload, driver or metric."""
    if not NAME_RE.match(name):
        raise ValueError(f"not a name: {name!r}")
    ext = ".py" if kind in ("drivers", "metrics") else ".json"
    return os.path.join(BENCH_DIR, kind, name + ext)


def load_module(kind: str, name: str):
    """A driver or metric file as a module (metric names hold dots)."""
    path = path_of(kind, name)
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(d: dict, dry: bool) -> dict:
    """``d`` with its ``dry`` overrides applied (nested one level) when
    ``dry``; the ``dry`` key itself dropped."""
    out = {k: v for k, v in d.items() if k != "dry"}
    if dry:
        for k, v in d.get("dry", {}).items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = {**out[k], **v}
            else:
                out[k] = v
    return out


def cell(name: str, *, dry: bool = False, bench: dict | None = None) -> dict:
    """Everything one run of cell ``name`` needs: its ``BENCHMARK.json``
    entry, its workload, configuration and traffic files (dry overrides
    applied with ``dry``), the end-to-end metrics it reports and its
    per-layer metrics."""
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {
        "name": name,
        "entry": entry,
        "workload": merged(load_json(path_of("workloads", name)), dry),
        "config": merged(load_json(path_of("configs", entry["config"])), dry),
        "traffic": merged(load_json(path_of("traffic", entry["traffic"])), dry),
        "end_to_end": e2e,
        "per_layer": layer,
    }


def problems(bench: dict) -> list[str]:
    """What in ``bench`` breaks the naming rules or names no file."""
    out = []

    def name_ok(what, n):
        if not isinstance(n, str) or not NAME_RE.match(n):
            out.append(f"{what}: bad name {n!r}")

    for c in bench["configs"]:
        name_ok("config", c["name"])
        for key in c["reduced"]:
            name_ok("reduced key", key)
        if not os.path.exists(os.path.join(ROOT, c["file"])):
            out.append(f"config {c['name']}: no file {c['file']}")
    for w in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            name_ok(f"workload {key}", w[key])
        for kind, n in (("workloads", w["name"]), ("traffic", w["traffic"]), ("configs", w["config"])):
            if NAME_RE.match(n) and not os.path.exists(path_of(kind, n)):
                out.append(f"workload {w['name']}: no {kind} file for {n}")
        if NAME_RE.match(w["name"]) and os.path.exists(path_of("workloads", w["name"])):
            drv = load_json(path_of("workloads", w["name"]))["driver"]
            if not os.path.exists(path_of("drivers", drv)):
                out.append(f"workload {w['name']}: no driver {drv}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        name_ok("metric", m["name"])
        if not UNIT_RE.match(m["unit"]):
            out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better must be lower or higher")
    for m in bench["per_layer"]:
        if NAME_RE.match(m["name"]) and not os.path.exists(path_of("metrics", m["name"])):
            out.append(f"metric {m['name']}: no reader file")
    names = [x["name"] for x in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, [w["name"] for w in bench["workloads"]], [c["name"] for c in bench["configs"]]):
        if len(set(group)) != len(group):
            out.append(f"duplicate names in {group}")
    return out

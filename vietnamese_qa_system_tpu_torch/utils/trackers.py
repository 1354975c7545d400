"""Experiment trackers: scalar metrics a logged step.

The port's copy of ``vietnamese_qa_system_tpu/utils/trackers.py``.  The
JSONL tracker is always there; ``report_to="wandb"`` makes a
:class:`WandbTracker` when ``wandb`` imports and its run starts, and falls
back to JSONL otherwise (offline, or without the package).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class JsonlTracker:
    def __init__(self, log_dir: str, run_name: Optional[str] = None):
        os.makedirs(log_dir, exist_ok=True)
        name = run_name or time.strftime("run_%Y%m%d_%H%M%S")
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")

    def log(self, metrics: dict, step: int) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_artifact(self, path: str, name: Optional[str] = None, type: str = "model") -> None:
        """Offline artifact record: one line pointing at the directory."""
        self.log({"artifact": path, "artifact_name": name or os.path.basename(path), "artifact_type": type}, step=-1)

    def finish(self) -> None:
        self._f.close()


class WandbTracker:
    def __init__(self, project: str, run_name: Optional[str] = None, config=None):
        import wandb  # optional dependency, imported only here

        self._run = wandb.init(project=project, name=run_name, config=config)

    def log(self, metrics: dict, step: int) -> None:
        self._run.log(metrics, step=step)

    def log_artifact(self, path: str, name: Optional[str] = None, type: str = "model") -> None:
        import wandb

        art = wandb.Artifact(name or os.path.basename(path), type=type)
        art.add_dir(path) if os.path.isdir(path) else art.add_file(path)
        self._run.log_artifact(art)

    def finish(self) -> None:
        self._run.finish()


def make_tracker(report_to: str, log_dir: str, run_name=None, config=None):
    if report_to == "wandb":
        try:
            return WandbTracker(project=run_name or "vqa_tpu", run_name=run_name, config=config)
        except Exception:
            pass  # no wandb, or its run did not start: fall back to jsonl
    return JsonlTracker(log_dir, run_name)

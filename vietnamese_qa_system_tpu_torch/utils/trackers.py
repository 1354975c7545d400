"""Experiment trackers.

The JSONL tracker of ``vietnamese_qa_system_tpu/utils/trackers.py``,
carried into the port: one line of scalar metrics per logged step.  The
wandb tracker is not ported yet.
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


def make_tracker(report_to: str, log_dir: str, run_name=None, config=None):
    if report_to == "wandb":
        raise NotImplementedError("the wandb tracker is not ported yet; use report_to='jsonl'")
    if report_to != "jsonl":
        raise ValueError(f"unknown tracker {report_to!r}")
    return JsonlTracker(log_dir, run_name)

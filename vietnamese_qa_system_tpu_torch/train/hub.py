"""Push an exported model to the Hugging Face Hub, offline-safe.

The port's copy of ``vietnamese_qa_system_tpu/train/hub.py``.  With a
token, ``huggingface_hub`` (imported only then) creates the repository and
uploads the directory.  A dry run, a missing token, a missing package or a
failed upload all leave ``push_manifest.json`` in the directory instead:
the repository id, its privacy, the reason, and every file with its size.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


def _manifest(export_dir: str, repo_id: str, private: bool, reason: str) -> dict:
    files = []
    for root, _, names in os.walk(export_dir):
        for n in names:
            if n == "push_manifest.json":
                continue
            p = os.path.join(root, n)
            files.append({"path": os.path.relpath(p, export_dir), "bytes": os.path.getsize(p)})
    return {"repo_id": repo_id, "private": private, "pushed": False, "reason": reason, "time": time.time(),
            "files": sorted(files, key=lambda f: f["path"])}


def push_to_hub(export_dir: str, repo_id: str, *, private: bool = True, token: Optional[str] = None,
                commit_message: str = "model update", dry_run: bool = False) -> dict:
    """Upload ``export_dir`` to the Hub, or record the intent offline.

    Returns {"pushed": bool, "reason": str, ...}; never raises on network
    or dependency failures (training must not die on a push)."""
    if not os.path.isdir(export_dir):
        raise ValueError(f"export dir {export_dir!r} does not exist")
    token = token or os.environ.get("HF_TOKEN")
    reason = None
    if dry_run:
        reason = "dry run requested"
    elif token is None:
        reason = "no token (set HF_TOKEN or pass token=)"
    if reason is None:
        try:
            from huggingface_hub import HfApi

            api = HfApi(token=token)
            api.create_repo(repo_id, private=private, exist_ok=True)
            api.upload_folder(folder_path=export_dir, repo_id=repo_id, commit_message=commit_message)
            return {"repo_id": repo_id, "private": private, "pushed": True}
        except Exception as e:  # offline / missing dependency / auth failure
            reason = f"upload failed: {type(e).__name__}: {e}"
    manifest = _manifest(export_dir, repo_id, private, reason)
    with open(os.path.join(export_dir, "push_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest

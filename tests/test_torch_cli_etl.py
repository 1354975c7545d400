"""The port's ``parse``, ``convert-ckpt`` and ``train --push-to-hub`` CLI
subcommands (and ``--report-to wandb``) against the JAX CLI's:

- ``parse`` (plain, ``--translate``, ``--ctx-pool``) writes JAX's file,
  byte for byte, and prints JAX's line;
- ``convert-ckpt`` of a checkpoint that the JAX CLI trained (tiny causal
  LoRA over a float and an int8 base; a tiny T5 LoRA run) equals the JAX
  CLI's ``convert-ckpt`` of it: ``--format hf`` the same files, tensors bit
  for bit, ``AutoConfig`` and generation_config.json (T5: the byte
  tokenizer's special-token ids); ``--format npz`` params.npz leaf for
  leaf and the same config.json; a checkpoint the port trained converts
  the same way in both CLIs; no checkpoint and a non-T5 seq2seq hf export
  exit 2 as in JAX;
- ``train --push-to-hub REPO --push-dry-run`` writes JAX's manifest (all
  but ``time``) beside the npz export and logs the artifact; without a
  token, with an upload that fails and with one that succeeds
  (``huggingface_hub.HfApi`` replaced), ``push_to_hub`` answers as JAX's;
- ``--report-to wandb`` with ``wandb`` blocked falls back to jsonl.

No test reaches the network.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.cli.main import main as jax_cli
from vietnamese_qa_system_tpu_torch.cli.main import main as cli

transformers = pytest.importorskip("transformers")

from test_torch_export_hf import assert_same_directory  # noqa: E402

torch.set_num_threads(2)
# a tiny T5 with the byte tokenizer's vocabulary room (train --model-config)
T5_CONFIG = dict(arch="seq2seq", seq2seq_family="t5", vocab_size=320, d_model=32, n_heads=2, d_kv=8, n_layers=1,
                 n_decoder_layers=1, d_ff=48, max_seq_len=512, mlp_gated=True, tie_embeddings=False,
                 relative_attention_buckets=8, relative_attention_max_distance=32, attention_bias=False)


def _raw(tmp_path, n=8) -> str:
    path = tmp_path / "raw.jsonl"
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            out = "def f(x):\n  return {x};\nimport os; class A: pass" if i == 3 else f"Giải thích hòa {i}"
            f.write(json.dumps({"instruction": f"Chủ đề {i}", "input": "", "output": out}, ensure_ascii=False) + "\n")
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--translate"], ["--ctx-pool"], ["--seed", "9"]])
def test_parse_equals_jax(tmp_path, capsys, extra):
    raw = _raw(tmp_path)
    args = ["--parser", "alpaca", "--input", raw]
    if extra == ["--ctx-pool"]:
        pool = tmp_path / "pool.txt"
        pool.write_text("nhiễu một\n\nnhiễu hai\n", encoding="utf-8")
        args = ["--parser", "ctx_injector", "--input", str(tmp_path / "qa.jsonl"), "--ctx-pool", str(pool)]
        with open(tmp_path / "qa.jsonl", "w", encoding="utf-8") as f:
            for i in range(6):
                f.write(json.dumps({"id": str(i), "question": "q", "documents": ["chính"], "answer": "a"}) + "\n")
    else:
        args += extra
    assert jax_cli(["parse", *args, "--output-dir", str(tmp_path / "jax")]) == 0
    want = capsys.readouterr().out
    assert cli(["parse", *args, "--output-dir", str(tmp_path / "port")]) == 0
    got = capsys.readouterr().out
    assert got == want.replace(str(tmp_path / "jax"), str(tmp_path / "port")) and got.startswith("wrote ")
    (name,) = os.listdir(tmp_path / "jax")
    assert os.listdir(tmp_path / "port") == [name]
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _train_args(train_file, ckpt, logs, *extra):
    return ["train", "--train-files", train_file, "--epochs", "1", "--batch-size", "4", "--max-steps", "1",
            "--max-len", "384", "--use-lora", "--lora-r", "4", "--lr", "1e-2", "--checkpoint-dir", ckpt,
            "--save-every-steps", "1", "--log-dir", logs, *extra]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """run -> (checkpoint dir, the convert-ckpt flags of its model), each
    trained by the JAX CLI: float LoRA (also pushed with --push-dry-run),
    LoRA over an int8 base, and a T5 LoRA run."""
    root = tmp_path_factory.mktemp("jax_runs")
    raw = _raw(root, 8)
    assert jax_cli(["parse", "--parser", "alpaca", "--input", raw, "--output-dir", str(root / "p")]) == 0
    data = str(root / "p" / "AlpacaParser.jsonl")
    t5_cfg = root / "t5.json"
    t5_cfg.write_text(json.dumps(T5_CONFIG))
    runs = {
        "float": ([], ["--push-to-hub", "org/test-repo", "--push-dry-run"]),
        "int8": (["--quantize-base", "int8"], []),
        "t5": (["--arch", "seq2seq", "--model-config", str(t5_cfg)], []),
    }
    out = {"data": data, "root": root}
    for name, (model_flags, extra) in runs.items():
        ckpt = str(root / f"ckpt_{name}")
        assert jax_cli([*_train_args(data, ckpt, str(root / f"logs_{name}"), *model_flags, *extra),
                        "--mesh", '{"data": 1}']) == 0
        out[name] = (ckpt, model_flags)
    return out


def _convert_args(ckpt, out_dir, fmt, model_flags):
    return ["convert-ckpt", "--checkpoint-dir", ckpt, "--out-dir", out_dir, "--use-lora", "--lora-r", "4",
            "--format", fmt, *model_flags]


def _lora_targets(d) -> list:
    """The T5 tensors that LoRA's default targets (q, k, v, o, wi, wo) touch."""
    return [k for k in torch.load(os.path.join(d, "pytorch_model.bin"), weights_only=True)
            if k.endswith((".q.weight", ".k.weight", ".v.weight", ".o.weight", "wi_0.weight", "wi_1.weight",
                           "wo.weight"))]


def _npz_leaves(d):
    with np.load(os.path.join(d, "params.npz")) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


def assert_same_npz_export(got, want, ulp: bool = False):
    """params.npz leaf for leaf (with ``ulp``, each leaf within one f32 ulp
    of its largest entry) and the same config.json."""
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    g, w = _npz_leaves(got), _npz_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert np.abs(a - b).max() <= np.spacing(np.abs(b).max()) if ulp else np.array_equal(a, b), i
    with open(os.path.join(got, "config.json")) as f1, open(os.path.join(want, "config.json")) as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("fmt", ["hf", "npz"])
@pytest.mark.parametrize("run", ["float", "int8", "t5"])
def test_convert_ckpt_of_a_jax_checkpoint_equals_jax(jax_runs, tmp_path, run, fmt, capsys):
    ckpt, model_flags = jax_runs[run]
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli(_convert_args(ckpt, want, fmt, model_flags)) == 0
    jax_out = capsys.readouterr().out
    assert cli(_convert_args(ckpt, got, fmt, model_flags) + ["--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert port_out.splitlines()[-1] == jax_out.splitlines()[-1].replace(want, got)
    for d in (want, got):  # the trainers' own logs
        for name in os.listdir(os.path.join(d, "_logs")):
            os.remove(os.path.join(d, "_logs", name))
    # The LoRA-merged T5 projections (inner width 16) may differ by one
    # f32 ulp: XLA's CPU dot rounds the (32, 4) @ (4, 16) factor product
    # otherwise than a sequential fused multiply-add, which torch's matmul
    # gives here and which both give at the causal runs' shapes (bit for bit)
    if fmt == "npz":
        assert_same_npz_export(got, want, ulp=run == "t5")
        return
    merged = [k for k in _lora_targets(want) if run == "t5"]
    assert_same_directory(got, want, ulp_names=merged)
    if run == "t5":
        with open(os.path.join(got, "config.json")) as f:
            written = json.load(f)
        assert (written["pad_token_id"], written["eos_token_id"], written["decoder_start_token_id"]) == (0, 2, 0)


def test_convert_ckpt_of_a_port_checkpoint_in_both_clis(jax_runs, tmp_path):
    """The port trains (int8 base, LoRA); both CLIs convert its checkpoint
    to the same directory, and it loads as int8c in the port."""
    from vietnamese_qa_system_tpu_torch.models import causal_from_hf

    ckpt = str(tmp_path / "ckpt")
    assert cli([*_train_args(jax_runs["data"], ckpt, str(tmp_path / "logs"), "--quantize-base", "int8"),
                "--device", "cpu"]) == 0
    flags = ["--quantize-base", "int8"]
    assert jax_cli(_convert_args(ckpt, str(tmp_path / "jax"), "hf", flags)) == 0
    assert cli(_convert_args(ckpt, str(tmp_path / "port"), "hf", flags) + ["--device", "cpu"]) == 0
    for d in ("jax", "port"):
        for name in os.listdir(tmp_path / d / "_logs"):
            os.remove(tmp_path / d / "_logs" / name)
    assert_same_directory(str(tmp_path / "port"), str(tmp_path / "jax"))
    model = causal_from_hf(str(tmp_path / "port"), device="cpu", quantize="int8c")
    assert model.blocks[0].attn.wq.w_q.dtype == torch.int8


def test_convert_ckpt_refusals_equal_jax(jax_runs, tmp_path, capsys):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for fn, dev in ((jax_cli, []), (cli, ["--device", "cpu"])):
        assert fn(_convert_args(empty, str(tmp_path / "out"), "hf", []) + dev) == 2
        assert f"no checkpoint found under {empty}" in capsys.readouterr().err
    # a seq2seq model outside the T5 family has no hf export
    ckpt = str(tmp_path / "native")
    assert cli([*_train_args(jax_runs["data"], ckpt, str(tmp_path / "logs"), "--arch", "seq2seq"),
                "--device", "cpu"]) == 0
    for fn, dev in ((jax_cli, []), (cli, ["--device", "cpu"])):
        assert fn(_convert_args(ckpt, str(tmp_path / "o"), "hf", ["--arch", "seq2seq"]) + dev) == 2
        assert "hf export supports causal and t5-family seq2seq models" in capsys.readouterr().err


def test_push_dry_run_writes_jax_manifest(jax_runs, tmp_path, capsys):
    logs = str(tmp_path / "logs")
    assert cli([*_train_args(jax_runs["data"], str(tmp_path / "ckpt"), logs, "--push-to-hub", "org/test-repo",
                             "--push-dry-run"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"hub push recorded offline (dry run requested) -> {logs}/export/push_manifest.json" in out
    with open(os.path.join(logs, "export", "push_manifest.json")) as f:
        got = json.load(f)
    with open(jax_runs["root"] / "logs_float" / "export" / "push_manifest.json") as f:
        want = json.load(f)
    assert isinstance(got.pop("time"), float) and isinstance(want.pop("time"), float)
    assert got == want
    export = os.path.join(logs, "export")
    assert {f["path"]: f["bytes"] for f in got["files"]} == {
        n: os.path.getsize(os.path.join(export, n)) for n in os.listdir(export) if n != "push_manifest.json"}
    # the export is the npz form of the merged model, and the artifact is logged
    leaves = _npz_leaves(export)
    assert all(leaf.dtype == np.float32 for leaf in leaves)
    text = "".join(open(os.path.join(logs, p)).read() for p in os.listdir(logs) if p.endswith(".jsonl"))
    assert '"artifact_name": "org/test-repo"' in text


class _FakeApi:
    """huggingface_hub.HfApi stand-in: records calls; ``fail`` raises from
    create_repo."""

    calls: list = []
    fail = False

    def __init__(self, token=None):
        _FakeApi.calls.append(("init", token))

    def create_repo(self, repo_id, private=True, exist_ok=False):
        if _FakeApi.fail:
            raise ConnectionError("no route to the hub")
        _FakeApi.calls.append(("create_repo", repo_id, private, exist_ok))

    def upload_folder(self, folder_path, repo_id, commit_message):
        _FakeApi.calls.append(("upload_folder", os.path.basename(folder_path), repo_id, commit_message))


@pytest.mark.parametrize("case", ["no_token", "upload_fails", "uploads"])
def test_push_paths_equal_jax(tmp_path, monkeypatch, case):
    import huggingface_hub

    from vietnamese_qa_system_tpu.train import hub as jhub
    from vietnamese_qa_system_tpu_torch.train import hub as thub

    monkeypatch.setattr(huggingface_hub, "HfApi", _FakeApi)
    if case == "no_token":
        monkeypatch.delenv("HF_TOKEN", raising=False)
    else:
        monkeypatch.setenv("HF_TOKEN", "hf_dummy")
    monkeypatch.setattr(_FakeApi, "fail", case == "upload_fails")
    results = []
    for mod in (jhub, thub):
        d = tmp_path / mod.__name__.split(".")[0] / "export"
        (d / "sub").mkdir(parents=True)
        (d / "params.npz").write_bytes(b"x" * 100)
        (d / "sub" / "extra.txt").write_text("y")
        _FakeApi.calls = []
        out = mod.push_to_hub(str(d), "org/repo")
        out.pop("time", None)
        manifest = d / "push_manifest.json"
        results.append((out, _FakeApi.calls, manifest.exists()))
    assert results[0] == results[1]
    out, calls, has_manifest = results[1]
    if case == "uploads":
        assert out == {"repo_id": "org/repo", "private": True, "pushed": True} and not has_manifest
        assert calls == [("init", "hf_dummy"), ("create_repo", "org/repo", True, True),
                         ("upload_folder", "export", "org/repo", "model update")]
    else:
        assert out["pushed"] is False and has_manifest
        assert ("token" in out["reason"]) == (case == "no_token")
        assert (out["reason"] == "upload failed: ConnectionError: no route to the hub") == (case == "upload_fails")
        assert [f["path"] for f in out["files"]] == ["params.npz", os.path.join("sub", "extra.txt")]
    with pytest.raises(ValueError, match="does not exist"):
        thub.push_to_hub(str(tmp_path / "nope"), "org/repo")


def test_report_to_wandb_falls_back_to_jsonl(jax_runs, tmp_path, monkeypatch):
    from vietnamese_qa_system_tpu.utils import trackers as jtrackers
    from vietnamese_qa_system_tpu_torch.utils import trackers as ttrackers

    monkeypatch.setitem(sys.modules, "wandb", None)
    for mod in (jtrackers, ttrackers):
        tracker = mod.make_tracker("wandb", str(tmp_path / mod.__name__.split(".")[0]), run_name="r")
        assert type(tracker).__name__ == "JsonlTracker"
        tracker.finish()
    logs = str(tmp_path / "logs")
    assert cli(["train", "--train-files", jax_runs["data"], "--max-steps", "1", "--batch-size", "2",
                "--max-len", "384", "--log-dir", logs, "--report-to", "wandb", "--run-name", "wb",
                "--log-every", "1", "--device", "cpu"]) == 0
    with open(os.path.join(logs, "wb.jsonl")) as f:
        assert "loss" in json.loads(f.readline())

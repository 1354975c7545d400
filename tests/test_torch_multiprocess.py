"""Two real processes on the CPU (a gloo process group, one process a
rank; tests/torch_mp_worker.py), following JAX
``tests/test_multiprocess.py``: each feeds half of the eval set, and
both must report the one-process totals (``perplexity_eval``, rtol 1e-5
for the float sum's order) and the whole set of predictions
(``generative_eval``); each writes its own ``host_{rank}`` file of a
sharded checkpoint, and the files together restore the state bit for
bit, in either process and in this one.  The loader's ``shard_for_process``
takes the process index and count from the group.

Several processes run here only: the chip machine has one card, and NCCL
refuses two ranks on one GPU."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_mp_data import gen_batches, model_state, ppl_batches
from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
from vietnamese_qa_system_tpu_torch.models import init_causal_lm, tiny_test
from vietnamese_qa_system_tpu_torch.train import CheckpointManager, generative_eval, perplexity_eval
from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 120  # seconds a process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_outputs(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("mp"))
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mp_worker.py"), str(r), port, outdir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker rc={p.returncode}:\n{log}"
    outs = []
    for r in range(2):
        with open(os.path.join(outdir, f"out_{r}.json")) as f:
            outs.append(json.load(f))
    return outs, outdir


def test_two_processes_really_ran(mp_outputs):
    outs, _ = mp_outputs
    assert [o["rank"] for o in outs] == [0, 1]
    assert [o["shard"] for o in outs] == [[0, 2, 4, 6], [1, 3, 5]]


def test_perplexity_allgather_matches_single_process(mp_outputs):
    outs, _ = mp_outputs
    cfg = tiny_test("causal")
    ref = perplexity_eval(init_causal_lm(cfg, torch.Generator().manual_seed(0)), cfg, ppl_batches())
    for o in outs:
        assert o["ppl"]["eval_tokens"] == ref["eval_tokens"]
        np.testing.assert_allclose(o["ppl"]["eval_loss"], ref["eval_loss"], rtol=1e-5)
        np.testing.assert_allclose(o["ppl"]["perplexity"], ref["perplexity"], rtol=1e-5)
    assert outs[0]["ppl"] == outs[1]["ppl"]


def test_generative_gather_gives_every_rank_the_full_set(mp_outputs):
    outs, _ = mp_outputs
    cfg = tiny_test("causal")
    ref = generative_eval(init_causal_lm(cfg, torch.Generator().manual_seed(0)), cfg, ByteTokenizer(), gen_batches(),
                          max_new_tokens=4)
    for o in outs:
        assert o["gen_n"] == 4
        assert o["gen_records"] == [r["prediction"] for r in ref["records"]]


def test_sharded_checkpoint_roundtrip_across_processes(mp_outputs):
    outs, outdir = mp_outputs
    assert all(o["ckpt_ok"] for o in outs)
    step = os.path.join(outdir, "ck", "step_7")
    assert sorted(f for f in os.listdir(step) if f.startswith("host_")) == [
        "host_0.layout.json", "host_0.npz", "host_1.layout.json", "host_1.npz"]
    with open(os.path.join(step, "host_1.layout.json")) as f:
        layout = json.load(f)["entries"]
    # rank 1 wrote the second half of each leaf of at least two rows, nothing else
    # (leaves in sorted key order: bias, one, step, w)
    assert [(e["leaf"], e["index"][0]) for e in layout] == [(0, [2, 5]), (3, [4, 9])]
    state = model_state()
    restored, meta = CheckpointManager(os.path.join(outdir, "ck"), sharded=True).restore(state)
    assert meta["tag"] == "mp"
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(state)))

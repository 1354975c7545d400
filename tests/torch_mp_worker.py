"""One of two processes of tests/test_torch_multiprocess.py: joins a gloo
process group on the CPU and runs what several processes change --
``perplexity_eval``'s gathered totals, ``generative_eval``'s gathered
records, the loader's per-process shard, and ``CheckpointManager``'s
sharded save (one ``host_{rank}`` file a process, barriers, rank 0's
marker) and its restore.  Writes ``out_{rank}.json``.

Usage: python torch_mp_worker.py <rank> <port> <outdir>  (not a test file).
"""

import json
import os
import sys


def main() -> None:
    rank, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    from vietnamese_qa_system_tpu_torch.core import distributed
    from vietnamese_qa_system_tpu_torch.data import QADataLoader
    from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.models import init_causal_lm, tiny_test
    from vietnamese_qa_system_tpu_torch.train import CheckpointManager, generative_eval, perplexity_eval
    from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

    from torch_mp_data import gen_batches, model_state, ppl_batches

    assert (distributed.process_index(), distributed.process_count()) == (rank, 2)
    cfg = tiny_test("causal")
    model = init_causal_lm(cfg, torch.Generator().manual_seed(0))
    ppl = perplexity_eval(model, cfg, ppl_batches()[rank::2])
    gen = generative_eval(model, cfg, ByteTokenizer(), [gen_batches()[rank]], max_new_tokens=4)
    shard = QADataLoader.shard_for_process(list(range(7)))

    state = model_state()
    mgr = CheckpointManager(os.path.join(outdir, "ck"), sharded=True)
    mgr.save(7, state, {"tag": "mp"})
    restored, meta = mgr.restore(state)
    ck_ok = meta["tag"] == "mp" and mgr.latest_step() == 7 and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(state)))
    out = {"rank": rank, "ppl": ppl, "gen_n": gen["n_examples"],
           "gen_records": [r["prediction"] for r in gen["records"]], "shard": shard, "ckpt_ok": bool(ck_ok)}
    with open(os.path.join(outdir, f"out_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    np.asarray(0)


if __name__ == "__main__":
    main()

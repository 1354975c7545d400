"""Find the knee of an open-loop generation cell: the highest Poisson rate
the engine sustains without a growing backlog.  One set-up, then one window
at each rate (a fresh engine each), on the chip:

    python3 portbench/sweep.py --workload gen_poisson_qa --seconds 40 --rates 1,2,3 --seed 7

Prints one JSON line a rate: requests due, time to first token (p50, p90,
p95, max), the requests waiting at the window's end and their most, the
slots in use.  The cell's ``rate`` (in its traffic file) is then set at
about four fifths of the knee, once; the benchmark's runs never sweep.
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness, spec, stats, traffic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.cache_env(spec.ROOT)
    import torch

    cell = spec.cell(args.workload)
    ctx = harness.Ctx(cell, args.seed, False, False)
    drv = spec.load_module("drivers", cell["workload"]["driver"]).Driver(ctx)
    drv.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        drv.gaps = traffic.gaps(drv.mix, ctx.seed, rate)
        out = drv.window(args.seconds, drain_s=20.0)
        rec, q = out["record"], out["record"]["queue"]
        ttft = rec["ttft_ms"]
        line = {"rate": rate, "requests": rec["requests"], "failed": out["failed"],
                "pending_end": q[-1][1] if q else None, "pending_max": max(x[1] for x in q) if q else None,
                "busy_slots_mean": sum(x[2] for x in q) / len(q) if q else None, "chunks": rec["chunks"]}
        if ttft:
            line.update({f"ttft_p{p}_ms": stats.percentile(ttft, p) for p in (50, 90, 95)})
            line["ttft_max_ms"] = max(ttft)
        print(json.dumps(line), flush=True)
        drv.engine = None
        gc.collect()
        torch.cuda.empty_cache()
        drv.engine = drv.new_engine()
    drv.engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

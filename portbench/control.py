"""The readings that a cell's limits are set from, on the chip at the cell's
own size: for each seed, one run of the program (set-up, a window, the
check's numbers: the lower readings) and, over the same window's outputs,
the control's numbers (the reference in the program's place, computed in
the precision below the configuration's, ``check.control`` of the workload
file: the upper readings).  All seeds run in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds 1,2,3

Prints one JSON line a seed.  The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args(argv)
    harness.cache_env(spec.ROOT)
    import torch

    from portbench import reference

    reference.strict_f32()
    cell = spec.cell(args.workload, dry=args.dry)
    mode = cell["workload"]["check"]["control"]
    for s in args.seeds.split(","):
        seed = int(s) % (1 << 63)
        ctx = harness.Ctx(cell, seed, False, args.dry)
        drv = spec.load_module("drivers", cell["workload"]["driver"]).Driver(ctx)
        drv.setup()
        out = drv.window(args.seconds)
        drv.release()
        gc.collect()
        if not args.dry:
            torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": int(s), "metrics": out["metrics"], "failed": out["failed"],
                "program": {n: v for n, v, _ in drv.check()}, "control": {n: v for n, v, _ in drv.check(mode)}}
        print(json.dumps(line), flush=True)
        del drv, ctx
        gc.collect()
        if not args.dry:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

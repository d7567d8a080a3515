"""Readings that the limits of ``correct`` are set from, for one cell, in
one process: for each seed the program's numbers after a short window at
the cell's own load, and for the control seeds the numbers of the control,
the reference in TF32 (the precision below the configuration's float32)
put in the program's place and judged by the same comparison.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 4 [--out FILE]

Not part of a benchmark run.  Prints one JSON line per seed, and writes
them all to ``--out``.
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from portbench.core import env

    env.prepare(root)
    import torch

    from portbench.core.harness import Cell, Context
    from portbench.core.trace import Tracer

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default="")
    args = p.parse_args()
    cell = Cell.find(args.workload)
    driver = cell.driver()
    device = torch.device("cuda")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        ctx = Context(cell, seed, args.seconds, Tracer(False), device)
        state = driver.setup(ctx)
        win = driver.window(state, ctx)
        kept = driver.release(state, ctx)
        ref = driver.outputs(kept, ctx)
        row = {"seed": seed, "attempted": win.attempted, "program": driver.compare(kept, ref)}
        if seed in control:
            ctl = driver.outputs(kept, ctx, tf32=True)
            row["control"] = driver.compare(driver.substitute(kept, ctl), ref)
        row["seconds"] = time.time() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del state, kept, ref
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)

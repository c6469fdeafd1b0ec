"""Readings of a cell's comparison, from which its limits are set.

    python3 benchmark/calibrate.py --workload <cell> --as <who> \
        --seeds <n,n,...> --seconds <s> [--check-every <k>]

``--as program`` runs the program, ``control`` the reference in the
nearest precision below the configuration's, ``half`` / ``altered`` /
``unchanged`` the reference with that fault planted, ``bf16`` the
reference rounded as the configuration computes
(:mod:`benchmark.control`), each on every seed in turn, in one process,
at the cell's own sizes and load, through the same set-up, window and
comparison as a run.  A line a seed, then one with the largest and the
smallest reading of each number.  The benchmark's own runs do not run
this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--as", dest="who", default="program")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--check-every", type=int, default=None)
    args = p.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if q and Path(q).resolve() != Path(here)]
    import torch
    from benchmark import harness
    program = None
    if args.who != "program":
        from benchmark.control import StandIn
        program = StandIn(args.who)
    cell = harness.load_cell(args.workload)
    if args.check_every:
        cell["params"] = dict(cell["params"], check_every=args.check_every)
    readings = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = harness.run_cell(cell, seed, args.seconds, False,
                               torch.device("cuda", 0), time.perf_counter(),
                               program)
        rec = {"as": args.who, "seed": seed, "correct": out["correct"],
               "checks": {k: v["value"] for k, v in out["checks"].items()},
               "info": out["info"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        readings.append(rec)
        print(json.dumps(rec), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    names = readings[0]["checks"]
    print(json.dumps({"as": args.who, "workload": args.workload,
                      "max": {k: max(r["checks"][k] for r in readings)
                              for k in names},
                      "min": {k: min(r["checks"][k] for r in readings)
                              for k in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

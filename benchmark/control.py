#!/usr/bin/env python3
"""Readings that set the limits of a cell's correctness numbers: for each
seed, the program's numbers (sound runs: the lower readings), and on the
control seeds the control's: the reference computed in bfloat16, the
precision below the configuration's float32, put in the program's place
(the upper readings), and with --faults the numbers of runs with a fault
planted in the timed path (benchmark/faults.py).  Each run drives --jobs
jobs, untimed, so that every run of one seed keeps the same jobs; the
float32 reference runs once per seed.  The benchmark's own runs never run
this.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults name,...] [--jobs 3]

One JSON line per reading, then one with the largest reading of each kind."""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import faults  # noqa: E402
from benchmark import run as bench  # noqa: E402


def drive(entry, ctx, jobs):
    st = entry.setup(ctx)
    for i in range(jobs):
        entry.collect(st, i, entry.job(st, i))
    entry.after_window(st)
    return st


def readings(cell, seed, jobs, control, fault_names, device=None, overrides=None,
             gen_dir=bench.GEN_DIR):
    """[(kind, readings)] of one seed."""
    import torch

    ctx = bench.prepare(cell, seed, device, overrides, gen_dir)
    entry = cell.entry()
    st = drive(entry, ctx, jobs)
    ref = entry.reference_outputs(st, torch.float32)
    out = [("program", entry.judge(st, st.out, ref))]
    if not control:
        return out
    out.append(("control", entry.judge(st, entry.reference_outputs(st, torch.bfloat16), ref)))
    for name in fault_names:
        with faults.BY_ENTRY[cell.entry_name][name]():
            fst = drive(entry, ctx, jobs)
        out.append((name, entry.judge(fst, fst.out, ref)))
    return out


def main(argv=None, **kw) -> int:
    from benchmark.lib.manifest import Cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    fault_names = [f for f in args.faults.split(",") if f]
    worst = {}
    for seed in seeds:
        for kind, r in readings(cell, seed, args.jobs, seed in control, fault_names, **kw):
            print(json.dumps({"seed": seed, "kind": kind, "readings": r}), flush=True)
            w = worst.setdefault(kind, {})
            for k, v in r.items():
                w[k] = max(w.get(k, v), v)
    print(json.dumps({"worst": worst, "limits": cell.limits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

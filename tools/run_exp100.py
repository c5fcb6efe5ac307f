#!/usr/bin/env python3
"""Run the reference experiment's full-size runs through the port on
one GPU, one process each, and keep what they report.

    python3 tools/run_exp100.py [--runs a,b,c,d] [--workdir build/exp100]
                                [--out runs/exp100] [--timeout S]

  a  experiments.full_pipeline with its defaults: 100 generated scenes at
     500x500/100 spp/16 bounces, 100,000 GCN epochs for train and train0,
     4 scenes evaluated, recovery of 16 scenes x 200 steps at 256x256/64 spp;
  b  experiments.recover100 as the JAX package's recover100_256 block ran
     it: 100 scenes at 256x256, spp 64, target spp 64, 1 key, average of the
     last 40, lr 1e-2, 100 steps, --init gcn;
  c  experiments.recover100 as recover100_512 ran it: 512x512, spp 32,
     target spp 256, average of the last 50, lr 1e-2, 80 steps, scene chunk
     50, --init gcn;
  d  run b with the GCN that run a trained on this package's graphs
     (<workdir>/a/gcn_params.npz) in place of the JAX package's: the in-repo
     asset fixture's graphs differ from those of the reference's asset tree
     on which artifacts/exp100/gcn_params.npz was trained.

Each run works in <workdir>/<run> (its caches and checkpoints: started
again on a directory that holds them, a run resumes) and logs to
<out>/<run>.log; its metrics.json, losses.jsonl, result arrays and a few
images go to <out>/<run>/ (the renders and graphs it caches stay in the
workdir).  The card's name and power limit are printed first, and each
run's wall seconds at its end.  Exits nonzero if a run failed.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from inverse_path_tracer_torch.experiments.common import device_names  # noqa: E402
R100 = ["--keys", "1", "--lr", "1e-2", "--init", "gcn"]
RUNS = {
    "a": ("full_pipeline", []),
    "b": ("recover100", ["--res", "256", "--spp", "64", "--target-spp", "64", "--avg", "40",
                         "--steps", "100", *R100]),
    "c": ("recover100", ["--res", "512", "--spp", "32", "--target-spp", "256", "--avg", "50",
                         "--steps", "80", "--scene-chunk", "50", *R100]),
    "d": ("recover100", ["--res", "256", "--spp", "64", "--target-spp", "64", "--avg", "40",
                         "--steps", "100", *R100, "--gcn", "{workdir}/a/gcn_params.npz"]),
}
# What a run's output directory keeps: small files only.
KEEP = ("metrics.json", "losses.jsonl", "recovered.npy", "gcn_init.npy", "recovered_gated.npy",
        "data.npz", "*_pred.png", "*_true.png", "preds/*.png", "preds0/*.png")


def keep(work: str, out: str) -> None:
    for pattern in KEEP:
        for path in glob.glob(os.path.join(work, pattern)):
            dst = os.path.join(out, os.path.relpath(path, work))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(path, dst)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="a,b,c,d")
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "exp100"))
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "exp100"))
    ap.add_argument("--timeout", type=float, default=3000.0, help="seconds per run")
    args = ap.parse_args()
    print(f"card: {'; '.join(device_names(torch.device('cuda', 0)))}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    failed = []
    for run in args.runs.split(","):
        module, extra = RUNS[run]
        work = os.path.join(args.workdir, run)
        cmd = [sys.executable, "-m", f"inverse_path_tracer_torch.experiments.{module}",
               "--workdir", work, *(a.format(workdir=args.workdir) for a in extra)]
        print(f"run {run}: {' '.join(cmd[1:])}", flush=True)
        t0 = time.time()
        with open(os.path.join(args.out, f"{run}.log"), "w") as log:
            try:
                rc = subprocess.run(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                    env=dict(os.environ, PYTHONPATH=REPO),
                                    timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
        keep(work, os.path.join(args.out, run))
        print(f"run {run}: exit {rc}, {time.time() - t0:.1f} s", flush=True)
        if rc != 0:
            failed.append(run)
    print(f"failed: {failed}" if failed else "all runs finished", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

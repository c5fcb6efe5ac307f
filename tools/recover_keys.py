#!/usr/bin/env python3
"""Run full_pipeline's recover phase under several keys, and print each
key's Kd error by triangle.

    python3 tools/recover_keys.py [--keys 0,1,2] [--out runs/recover_keys.json]
                                  [full_pipeline flags]

The scenes are made and rendered as full_pipeline's generate phase makes
them (by default 500x500/100 spp/16 bounces, seed 0), as many as its
--recover-n (16), into its --workdir (default build/recover_keys). Each key
then recovers them from Kd 0.5 as its recover phase does (by default
256x256/64 spp, 200 steps, lr 5e-2); key 0 is the recover phase's own.
Prints the device (a card's name and power limit), then per key its wall
seconds, final loss, mean Kd error and the error of each triangle (the mean
over the scenes and the channels), and writes them as JSON to --out.
Runs on the card, or on the CPU with full_pipeline's --cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from inverse_path_tracer_torch.config import RenderConfig  # noqa: E402
from inverse_path_tracer_torch.experiments import full_pipeline  # noqa: E402
from inverse_path_tracer_torch.experiments.common import device_names, seconds_since  # noqa: E402
from inverse_path_tracer_torch.render.forward import resolve_device  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", default="0,1,2")
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "recover_keys.json"))
    args, rest = ap.parse_known_args()
    fp = full_pipeline.build_parser()
    fp.set_defaults(workdir=os.path.join(REPO, "build", "recover_keys"))
    fa = fp.parse_args(rest)
    dev = resolve_device("cpu" if fa.cpu else None)
    print(f"device: {'; '.join(device_names(dev))}", flush=True)
    full_pipeline.main([*rest, "--workdir", fa.workdir, "--n", str(fa.recover_n),
                        "--phases", "generate"])
    rcfg = RenderConfig(width=fa.recover_res, height=fa.recover_res, spp=fa.recover_spp,
                        max_bounces=fa.bounces)
    out = {"devices": device_names(dev), "scenes": fa.recover_n, "res": fa.recover_res,
           "spp": fa.recover_spp, "steps": fa.recover_steps, "keys": {}}
    for key in (int(k) for k in args.keys.split(",")):
        t0 = time.time()
        mats, labels, losses = full_pipeline.recover(fa.workdir, fa.recover_n, rcfg,
                                                     fa.recover_steps, fa.asset_root, dev, key)
        err = np.abs(mats - labels)
        out["keys"][key] = {"wall_s": seconds_since(t0, dev), "final_loss": losses[-1],
                            "mean_kd_err": float(err.mean()),
                            "per_tri_err": [round(float(v), 4) for v in err.mean(axis=(0, 2))]}
        print(f"key {key}: {json.dumps(out['keys'][key])}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

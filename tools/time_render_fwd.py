#!/usr/bin/env python3
"""Time the port's forward megakernel (B1, render_tile) in one or more
checkouts of the repository, in turns, on one GPU.

    python3 tools/time_render_fwd.py TREE [TREE ...]

Each TREE is the root of a checkout (for instance the working tree and an
unpacked `git archive` of its parent, in a directory that .gitignore
lists).  For each tree a fresh process builds the kernels from that tree's
sources, prints ptxas's register and spill lines of render_fwd.cu, checks
B1 against its plain version on scene 0's first 2^20-ray launch of the
512x512/64 spp/16 bounce render (fused RNG, key 0) and prints the mean of
20 launches timed with CUDA events.  Trees are run in the order given, so
pass them as A B B A to compare two versions within one call.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r'''
import os, sys
tree = sys.argv[1]
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
from inverse_path_tracer_torch import RenderConfig
from inverse_path_tracer_torch.ops.kernels import build
from inverse_path_tracer_torch.ops.kernels.render_kernel import render_tile, render_tile_plain

build.build(["render_fwd"])
for line in build.build_log.get("render_fwd", "").splitlines():
    if "registers" in line or "spill" in line:
        print("  ptxas:", line.strip())
dev = torch.device("cuda", 0)
cfg = RenderConfig(width=512, height=512, spp=64, max_bounces=16)
scene, mats = cs.fixture(dev)
a = cs.tile_inputs(scene, cfg, 0, cfg.tile_size, dev, external=False)
rk, sk = render_tile(mats, scene, cfg, **a)
rp, sp = render_tile_plain(mats, scene, cfg, **a)
same = torch.equal(rk, rp) and torch.equal(sk, sp)
cs.cuda_ms(lambda: render_tile(mats, scene, cfg, **a), 3)
ms = cs.cuda_ms(lambda: render_tile(mats, scene, cfg, **a), 20)
print(f"{tree}: render_fwd at (3, {cfg.tile_size}) {ms:.4f} ms (mean of 20), bit-equal to "
      f"plain {same}", flush=True)
'''


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip(), flush=True)
    rc = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree)])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's sweeping kernels in one or more checkouts of the
repository, in turns, on one GPU.

    python3 tools/time_render_fwd.py [--widths 768,32] [--forward] TREE [TREE ...]

Each TREE is the root of a checkout (for instance the working tree and an
unpacked `git archive` of its parent, in a directory that .gitignore
lists).  For each tree a fresh process builds the kernels from that tree's
sources, prints ptxas's register and spill lines of render_fwd.cu, and
times with CUDA events (after warm-up launches):

  * B1 on scene 0's first 2^20-ray launch of the 512x512/64 spp/16 bounce
    render (fused RNG, key 0), the dense main path, with the inputs the
    tree's main path passes (a tree whose chip_smoke.py has camera_launch:
    the kernel makes the rays; else camera_rays' rays), checked bit for bit
    against its plain version (mean of 20 launches);
  * at each cluster width of --widths, on the first 2^20-ray launch of the
    large vertex-normal scene's render at the same configuration: B1 with
    clustered tables and the main path's inputs (mean of 5; its radiance
    and counts checked bit for bit against B1 with dense tables), and B8
    at stage 0 and stage 2 on the
    carries of the staged orchestration (B7, then per stage the binned
    sort; mean of 20 each after 2 warm-up launches; at the first width the share of lanes equal to
    its plain version is printed);
  * with --forward, at each width B7 alone on that launch with the main
    path's inputs (mean of 20 after 2 warm-up launches; a digest of its
    carry, the same in two trees where the carries are bit-equal, and its
    grid), and the large staged forward render_samples (three runs after a
    warm-up).

Trees are run in the order given, so pass them as A B B A to compare two
versions within one call.  Lines that start with RESULT carry one number
each.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = r'''
import hashlib, inspect, os, sys
tree, widths, forward = sys.argv[1], [int(w) for w in sys.argv[2].split(",") if w], sys.argv[3] == "1"
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
from inverse_path_tracer_torch import RenderConfig, large_scene, render_samples
from inverse_path_tracer_torch.ops.kernels import build
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    pack_tables, render_tile, render_tile_plain)
from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
    init_tile, stage_tile, stage_tile_plain)
from inverse_path_tracer_torch.render.forward import _binned_order, _scene_bins

name = os.path.basename(os.path.normpath(tree)) or tree
build.build(["render_fwd"])
for line in build.build_log.get("render_fwd", "").splitlines():
    if "registers" in line or "spill" in line or "Compiling entry" in line:
        print("  ptxas:", line.strip())
dev = torch.device("cuda", 0)
cfg = RenderConfig(width=512, height=512, spp=64, max_bounces=16)
n = cfg.tile_size
scene, mats = cs.fixture(dev)
camera_mode = hasattr(cs, "camera_launch")
a = (cs.camera_launch(n, 0) if camera_mode
     else cs.tile_inputs(scene, cfg, 0, n, dev, external=False))
rk, sk = render_tile(mats, scene, cfg, **a)
rp, sp = render_tile_plain(mats, scene, cfg, **a)
same = torch.equal(rk, rp) and torch.equal(sk, sp)
cs.cuda_ms(lambda: render_tile(mats, scene, cfg, **a), 3)
ms = cs.cuda_ms(lambda: render_tile(mats, scene, cfg, **a), 20)
print(f"RESULT {name} b1_scene0 {ms:.4f} ms (mean of 20, bit-equal to plain {same})", flush=True)

big = large_scene(dev)
bm = big.diffuse
ab = cs.tile_inputs(big, cfg, 0, n, dev, external=False)  # B7's rays, for B8's carries
am = cs.camera_launch(n, 0) if camera_mode else ab  # B1's: the main path's inputs
dense = pack_tables(big, bm)
rd, sd = render_tile(bm, big, cfg, tables=dense, **am)
takes_live = "live" in inspect.signature(stage_tile).parameters
for w in widths:
    c = cfg.with_(cluster_k=w)
    tabs = pack_tables(big, bm, c)
    rb, sb = render_tile(bm, big, c, tables=tabs, **am)
    eq = torch.equal(rb, rd) and torch.equal(sb, sd)
    cs.cuda_ms(lambda: render_tile(bm, big, c, tables=tabs, **am), 1)
    ms = cs.cuda_ms(lambda: render_tile(bm, big, c, tables=tabs, **am), 5)
    print(f"RESULT {name} b1_large_k{w} {ms:.4f} ms (mean of 5, bit-equal to dense B1 {eq})",
          flush=True)
    bins = _scene_bins(big, c)
    carry, orig, k = init_tile(bm, big, c, ab["p"], ab["d"], ab["alive"], tables=tabs), ab["orig"], 4
    for s in range(3):
        order = _binned_order(carry, *bins, c.bin_cells)
        carry, orig = carry[:, order].contiguous(), orig[:, order].contiguous()
        kw = dict(keys=ab["keys"], tables=tabs)
        if takes_live:
            kw["live"] = (carry[17] > 0).sum(dtype=torch.int32).reshape(1)
        run = lambda carry=carry, orig=orig, s=s, kw=kw: stage_tile(bm, big, c, carry, orig, s * k,
                                                                    k, **kw)
        if s in (0, 2):
            out = run()
            agree = ""
            if w == widths[0]:  # B8 against its plain version once per tree
                want = stage_tile_plain(bm, big, c, carry, orig, s * k, k, keys=ab["keys"])
                agree = f", lanes equal to plain {float((out == want).all(0).float().mean()):.5f}"
            cs.cuda_ms(run, 2)
            ms = cs.cuda_ms(run, 20)
            live = int((carry[17] > 0).sum())
            print(f"RESULT {name} b8_stage{s}_k{w} {ms:.4f} ms (mean of 20, {live} live lanes"
                  f"{agree})", flush=True)
        carry = run()
    if forward:
        b7 = (lambda: init_tile(bm, big, c, camera=am["camera"], tables=tabs)) if camera_mode \
            else (lambda: init_tile(bm, big, c, ab["p"], ab["d"], ab["alive"], tables=tabs))
        carry = b7()
        h = hashlib.sha256(carry.cpu().numpy().tobytes()).hexdigest()[:16]
        del carry
        cs.cuda_ms(b7, 2)
        ms = cs.cuda_ms(b7, 20)
        print(f"RESULT {name} b7_k{w} {ms:.4f} ms (mean of 20, carry digest {h}, "
              f"{getattr(init_tile, 'blocks', '-')} blocks)", flush=True)
        render = lambda key: render_samples(bm, big, key, c, device=dev)
        render(1)
        for r in range(3):
            ms = cs.cuda_ms(lambda: render(r + 2), 1)
            print(f"RESULT {name} forward_large_k{w}_run{r} {ms:.3f} ms", flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="768,32",
                    help="comma-separated cluster widths for the large-scene kernels")
    ap.add_argument("--forward", action="store_true",
                    help="also time the large staged forward at each width")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip(), flush=True)
    rc = 0
    for tree in args.trees:
        proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree), args.widths,
                               "1" if args.forward else "0"])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

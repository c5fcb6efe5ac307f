#!/usr/bin/env python3
"""Time the port's extraction kernels and extractions in one or more
checkouts of the repository, in turns, on one GPU.

    python3 tools/time_extract.py [--profile] [--layouts-242] TREE [TREE ...]

Each TREE is the root of a checkout (for instance the working tree and an
unpacked `git archive` of its parent, in a directory that .gitignore
lists).  For each tree a fresh process builds the kernels from that tree's
sources, prints ptxas's register and spill lines of inverse.cu, and times
with CUDA events (after warm-up launches), at the reference dataset
configuration (500x500/100 spp/16 bounces, fused RNG, key 0):

  * B5 on scene 0's first 2^20-ray extraction launch (mean of 10);
  * B6 with the records sink and, where the tree has it, with the
    global-grid sink, on the first extraction launch of the 242-triangle
    vertex-normal scene and of the 1298-triangle large scene, each in the
    tree's own layout (mean of 5 each); the global grid is first held against
    the records reduced by grids_from_edge_records (chip_smoke.grid64_match:
    rtol 1e-9, a floor of 1e-12 of the largest entry, visit counts equal)
    and its counts against the records sink's;
  * B1 on scene 0's and the 242-triangle scene's first 2^20-ray launch of
    the 512x512/64 spp/16 bounce render (mean of 20);
  * every kernel with the inputs the tree's main path passes (a tree whose
    chip_smoke.py has camera_launch: the kernels make the rays and read
    the pixels from the target image);
  * the three extractions (scene 0, the 242-triangle scene, the large
    scene), trace_transport_range over all samples: one warm-up, 3 runs,
    ms and rays/s, and the launches of each inverse kernel;
  * render_image and loss_and_grad_range on the 242-triangle scene at
    512x512/64 spp/16 bounces (one warm-up, 3 runs each) at wavefront
    "auto" (the tree's own choice, printed), "mega" and "staged", in the
    tree's own layout: what the cluster threshold does to the render paths;
  * with --profile, a torch.profiler table of one 242-triangle and one
    large extraction (device busy share, top kernels, aten::nonzero
    calls), and camera_rays alone over the 24 launches;
  * with --layouts-242, B6 (both sinks) and B1 on the 242-triangle scene
    and that extraction again, dense and with clusters of the auto width
    (CLUSTER_MIN_TP set in the process above and below its 248 padded
    triangles), whatever the tree's own threshold.

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
import os, sys, time
tree, profile, layouts_242 = sys.argv[1], *(a == "1" for a in sys.argv[2:4])
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
from inverse_path_tracer_torch import (RenderConfig, large_scene, loss_and_grad_range, render_image,
                                       trace_transport_range)
from inverse_path_tracer_torch.ops.kernels import build, clusters
from inverse_path_tracer_torch.ops.kernels import inverse_kernel as ik
from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables, render_tile
from inverse_path_tracer_torch.ops.tonemap import tonemap_mean
from inverse_path_tracer_torch.render.forward import _use_staged, camera_rays

name = os.path.basename(os.path.normpath(tree)) or tree
build.build(["inverse", "render_fwd"])
for kernel, regs, st, ld, stack in cs.ptxas_report(build.build_log.get("inverse", "")):
    print(f"  ptxas {name} {kernel}: {regs} registers, spill stores {st} B, spill loads {ld} B",
          flush=True)
dev = torch.device("cuda", 0)
has_global = hasattr(ik, "inverse_tile_global")
cfg = RenderConfig(**cs.GOLDEN)
scene0, mats0 = cs.fixture(dev)
(_, s242, m242), = [v for v in cs.variant_scenes(dev) if v[0] == "vertex_normals"]
big = large_scene(dev)
scenes = {"scene0": scene0, "vn242": s242, "large": big}
targets = {k: render_image(s.diffuse, s, 1, cfg, device=dev) for k, s in scenes.items()}
torch.cuda.synchronize()


def result(key, value, unit, note=""):
    print(f"RESULT {name} {key} {value:.4f} {unit}{note}", flush=True)


def first_launch(scene, c):
    """The first extraction launch's inputs as the tree's extraction passes
    them, the pixel input as keywords (pix, or the image in camera mode),
    each lane's pixel (3, n) and the tables."""
    out = cs.first_extraction_launch(scene, c, targets[label_of[id(scene)]])
    if len(out) == 4:  # camera mode: (inputs, {"image": ...}, pix, tables)
        a, px, pix, _ = out
    else:
        a, pix, _ = out
        px = {"pix": pix}
    return a, px, pix, pack_tables(scene, scene.diffuse, c)


label_of = {id(s): k for k, s in scenes.items()}
a0, px0, _, tab0 = first_launch(scene0, cfg)
run5 = lambda: ik.inverse_tile(scene0, cfg, tables=tab0, **px0, **a0)
run5()
result("b5_scene0", cs.cuda_ms(run5, 10), "ms", " (mean of 10)")


def b6(label, scene, c, suffix=""):
    a, px, pix, tab = first_launch(scene, c)
    rec = lambda: ik.inverse_tile_rec(scene, c, tables=tab, **a)
    r, st_r = rec()
    result(f"b6_rec_{label}{suffix}", cs.cuda_ms(rec, 5), "ms",
           f" (mean of 5, clusters {tab.cluster_k})")
    if not has_global:
        return
    want = ik.grids_from_edge_records(r, pix.T, scene, c, tab.perm)
    del r
    acc, st_g = ik.inverse_tile_global(scene, c, tables=tab, **px, **a)
    got = ik.unperm_grid(acc, tab.perm)
    ok, _ = cs.grid64_match(got, want)
    ok = ok and torch.equal(st_g, st_r)
    print(f"check {name} {label}{suffix}: global grid against the reduced records max |d| "
          f"{float((got - want).abs().max()):.3e} of max {float(want.abs().max()):.3e}, counts "
          f"equal {torch.equal(got[..., 8], want[..., 8])}, stats equal {torch.equal(st_g, st_r)}"
          f" -> {'OK' if ok else 'FAIL'}", flush=True)
    glob = lambda: ik.inverse_tile_global(scene, c, tables=tab, acc=acc, **px, **a)
    glob()
    result(f"b6_global_{label}{suffix}", cs.cuda_ms(glob, 5), "ms",
           f" (mean of 5, clusters {tab.cluster_k})")


b6("vn242", s242, cfg)
b6("large", big, cfg)

main = RenderConfig(**cs.MAIN)


def b1(label, scene, c):
    n = min(c.tile_size, c.n_samples)
    a = (cs.camera_launch(n, 0) if hasattr(cs, "camera_launch")
         else cs.tile_inputs(scene, c, 0, n, dev, external=False))
    tab = pack_tables(scene, scene.diffuse, c)
    run = lambda: render_tile(scene.diffuse, scene, c, tables=tab, **a)
    run()
    result(f"b1_{label}", cs.cuda_ms(run, 20), "ms", f" (mean of 20, clusters {tab.cluster_k})")


b1("scene0", scene0, main)
b1("vn242", s242, main)


def extraction(label, scene, suffix=""):
    ext = lambda: trace_transport_range(scene, targets[label], 0, cfg, 0, cfg.n_samples,
                                        device=dev)
    counters = [f for f in ("inverse_tile", "inverse_tile_rec", "inverse_tile_global")
                if hasattr(ik, f)]
    for f in counters:
        getattr(ik, f).launches = 0
    _, stats = ext()
    torch.cuda.synchronize()
    rays = int(stats.segments) + int(stats.shadow_rays)
    print(f"extraction {name} {label}{suffix}: launches " + ", ".join(
        f"{f} {getattr(ik, f).launches}" for f in counters) + f"; rays {rays}", flush=True)
    for k in range(3):
        t = cs.cuda_ms(ext, 1)
        result(f"extract_{label}{suffix}_run{k}", t, "ms", f" ({rays / (t / 1e3):.6e} rays/s)")
    return ext


exts = {label: extraction(label, s) for label, s in scenes.items()}

n_values = main.width * main.height * 3
post = lambda vals, start: tonemap_mean(vals, main.spp).sum() / n_values
print(f"render {name} vn242: auto is {'staged' if _use_staged(main, s242) else 'mega'}, "
      f"clusters {pack_tables(s242, s242.diffuse, main).cluster_k}", flush=True)
for wf in ("auto", "mega", "staged"):
    c = main.with_(wavefront=wf)
    jobs = {"render": lambda: render_image(m242, s242, 0, c, device=dev),
            "lgr": lambda: loss_and_grad_range(m242, s242, 0, c, 0, c.n_samples, post,
                                               device=dev)}
    for what, fn in jobs.items():
        fn()
        for k in range(3):
            result(f"{what}_vn242_{wf}_run{k}", cs.cuda_ms(fn, 1), "ms")

if profile:
    n_launch = -(-cfg.n_samples // cfg.tile_size)
    idx = torch.arange(cfg.tile_size, device=dev)
    cam = lambda: [camera_rays(s242, cfg, 0, idx) for _ in range(n_launch)]
    cam()
    result("camera_rays_24_launches", cs.cuda_ms(cam, 3), "ms")
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    for label in ("vn242", "large"):
        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exts[label]()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        dev_ev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
        nonzero = sum(e.count for e in ev if e.key == "aten::nonzero")
        print(f"profile {name} {label} extraction (profiler on): wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}%), idle {wall - busy:.3f} ms, "
              f"aten::nonzero calls {nonzero}", flush=True)
        for e in sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5d} {e.key[:110]}",
                  flush=True)
    if not has_global:  # the parent's records reduction of one launch
        a, _, pix, tab = first_launch(s242, cfg)
        r, _ = ik.inverse_tile_rec(s242, cfg, tables=tab, **a)
        red = lambda: ik.grids_from_edge_records(r, pix.T, s242, cfg, tab.perm)
        red()
        result("reduction_vn242_launch", cs.cuda_ms(red, 3), "ms")

if layouts_242:
    own = clusters.CLUSTER_MIN_TP
    for min_tp, suffix in ((1 << 30, "_dense"), (128, "_k16")):
        clusters.CLUSTER_MIN_TP = min_tp
        b6("vn242", s242, cfg, suffix)
        b1(f"vn242{suffix}", s242, main)
        extraction("vn242", s242, suffix)
    clusters.CLUSTER_MIN_TP = own

'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one 242-triangle and one large extraction")
    ap.add_argument("--layouts-242", action="store_true",
                    help="also time the 242-triangle scene dense and clustered")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip(), flush=True)
    rc = 0
    for tree in args.trees:
        flags = ("1" if f else "0" for f in (args.profile, args.layouts_242))
        proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree), *flags])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's gradient kernels and gradient paths in one or more
checkouts of the repository, in turns, on one GPU.

    python3 tools/time_grad.py [--profile] [--large] [--after-smoke] [--once] TREE [TREE ...]

Each TREE is the root of a checkout (for instance the working tree and an
unpacked `git archive` of its parent, in a directory that .gitignore
lists).  For each tree a fresh process builds the kernels from that tree's
sources, prints ptxas's registers and spills of render_fwd.cu and
render_bwd.cu, and times with CUDA events (after warm-up launches), on
scene 0's first 2^20-ray launch of the 512x512/64 spp/16 bounce render
(fused RNG, key 0), with the inputs the tree's main path passes (a tree
whose chip_smoke.py has camera_launch: the kernels make the rays; else the
rays of camera_rays):

  * B1, B3, B2 and B4 (mean of 10 launches each), each checked against its
    plain version on the same inputs: B1's radiance within rtol 1e-4 /
    atol 1e-5 and its counts equal; B3's radiance and counts equal to B1's
    bit for bit and its records within rtol 1e-4 / atol 1e-5 of the plain
    ones; B2 and B4 within chip_smoke.grad_close; B2 and B4 bit-equal across
    two calls, and a digest of B4's output (the same digest in two trees:
    the same bits); in a tree with camera mode also B1 fed the camera_rays'
    rays (b1_scene0_rays), bit-equal to B1 in camera mode;
  * the scene-0 forward (render_samples), fwd+bwd (render_samples,
    tonemap_mean(...).mean().backward()) and loss_and_grad_range at that
    configuration, one warm-up and three timed runs each;
  * with --profile, a torch.profiler table of one loss_and_grad_range: the
    device time by kernel, the busy share, and the CPU ops by self time
    with the calls that wait for the device and the kernel launches; then
    the paths timed again in the same process, after the profiler;
  * with --large, clustered B3 and B2 on the first 2^20-ray launch of the
    large vertex-normal scene's render (mean of 5; in a tree with camera
    mode also fed camera_rays' rays), B4 on that B3's records (mean of 10,
    checked against its plain version and twice bit-equal), and B9 on that
    launch's stage-0 records (B7, then B8 with records), checked against
    its plain version and twice bit-equal (mean of 10), with digests of
    B4's and B9's outputs; then the large fwd+bwd (one warm-up, 2 runs) and
    B9's device time in a profile of one;
  * with --once, only one B3 and one B2 launch on scene 0's inputs and
    nothing else, for a profiler that wraps the command, as in
    `ncu -k regex:'grad_tile|render_rec|render_fwd' --metrics
    dram__bytes_write.sum python3 tools/time_grad.py --once TREE`;
  * with --after-smoke, first the tree's own chip_smoke.py phases 3 to 7
    (kernel checks, forward, golden, fwd+bwd, loss_and_grad_range with
    their timings and profiles) in the same process, so that the numbers
    above are taken in the state those phases leave.

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
import hashlib, os, sys, time
tree = sys.argv[1]
profile, large, after_smoke, once = (f == "1" for f in sys.argv[2:6])
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
from inverse_path_tracer_torch import (RenderConfig, large_scene, loss_and_grad_range,
                                       render_samples)
from inverse_path_tracer_torch.ops.kernels import build
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    grad_tile, grad_tile_plain, pack_tables, render_tile, render_tile_plain, render_tile_rec,
    render_tile_rec_plain, reverse_tile, reverse_tile_plain)
from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

name = os.path.basename(os.path.normpath(tree)) or tree
digest = lambda *ts: hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]
# A build directory of this process's own, so that ptxas's report is always printed.
build.BUILD_DIR = os.path.join(tree, "build", f"kernels_{os.getpid()}")
build.build(["render_fwd", "render_bwd"])
for lib in ("render_fwd", "render_bwd"):
    for kernel, regs, st, ld, stack in cs.ptxas_report(build.build_log.get(lib, "")):
        print(f"  ptxas {name} {lib} {kernel}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B, stack {stack} B", flush=True)
dev = torch.device("cuda", 0)
if after_smoke:  # chip_smoke.py's phases 3-7 of this tree, in this process
    cs.check_kernel_vs_plain(dev)
    cs.main_path(dev)
    cs.golden(dev)
    _, grad_ref = cs.fwd_bwd_path(dev)
    cs.loss_and_grad_path(dev, grad_ref)
    mem = torch.cuda.memory_stats(dev)
    print(f"  {name} after chip_smoke phases 3-7: reserved {torch.cuda.memory_reserved(dev)} B, "
          f"allocated {torch.cuda.memory_allocated(dev)} B, cudaMalloc retries "
          f"{mem.get('num_alloc_retries', 0)}, segments {mem.get('segment.all.current', 0)}",
          flush=True)
cfg = RenderConfig(width=512, height=512, spp=64, max_bounces=16)
n = cfg.tile_size
scene, mats = cs.fixture(dev)
camera_mode = hasattr(cs, "camera_launch")
main_inputs = lambda: (cs.camera_launch(n, 0) if camera_mode
                       else cs.tile_inputs(scene, cfg, 0, n, dev, external=False))
a = main_inputs()
g = torch.rand((3, n), generator=torch.Generator().manual_seed(5)).to(dev)
nt = scene.n_tri
if once:
    render_tile_rec(mats, scene, cfg, **a)
    grad_tile(mats, scene, cfg, g=g, **a)
    torch.cuda.synchronize()
    print(f"  {name}: one B3 and one B2 launch on scene 0's first launch", flush=True)
    raise SystemExit(0)

r1, s1 = render_tile(mats, scene, cfg, **a)
rp, sp = render_tile_plain(mats, scene, cfg, **a)
ok1 = bool(torch.allclose(r1, rp, rtol=1e-4, atol=1e-5)) and torch.equal(s1, sp)
del rp, sp
r3, s3, rec = render_tile_rec(mats, scene, cfg, **a)
_, _, rec_p = render_tile_rec_plain(mats, scene, cfg, **a)
ok3 = (torch.equal(r3, r1) and torch.equal(s3, s1)
       and bool(torch.allclose(rec, rec_p, rtol=1e-4, atol=1e-5)))
del rec_p
d2 = grad_tile(mats, scene, cfg, g=g, **a)
d2b = grad_tile(mats, scene, cfg, g=g, **a)
ok2 = cs.grad_close(d2, grad_tile_plain(mats, scene, cfg, g=g, **a))
d4 = reverse_tile(nt, cfg, rec, g)
ok4 = cs.grad_close(d4, reverse_tile_plain(nt, cfg, rec, g))
same4 = torch.equal(reverse_tile(nt, cfg, rec, g), d4)
blocks = (getattr(grad_tile, "blocks", None), getattr(render_tile_rec, "blocks", None))
print(f"  {name}: checks B1 {ok1}, B3 = B1 and records {ok3}, B2 {ok2} (twice bit-equal "
      f"{torch.equal(d2, d2b)}), B4 {ok4} (twice bit-equal {same4}, digest {digest(d4)}); "
      f"persistent blocks B2, B3 {blocks}", flush=True)
if not (ok1 and ok3 and ok2 and ok4):
    raise SystemExit(f"{name}: a kernel disagrees with its plain version")

if camera_mode:
    rays = cs.tile_inputs(scene, cfg, 0, n, dev, external=False)
    r1r, s1r = render_tile(mats, scene, cfg, **rays)
    print(f"  {name}: B1 in camera mode = B1 fed camera_rays' rays "
          f"{torch.equal(r1r, r1) and torch.equal(s1r, s1)}", flush=True)
    fn = lambda: render_tile(mats, scene, cfg, **rays)
    cs.cuda_ms(fn, 2)
    print(f"RESULT {name} b1_scene0_rays {cs.cuda_ms(fn, 10):.4f} ms (mean of 10)", flush=True)
    del rays, r1r, s1r
timed = {
    "b1": lambda: render_tile(mats, scene, cfg, **a),
    "b3": lambda: render_tile_rec(mats, scene, cfg, **a),
    "b2": lambda: grad_tile(mats, scene, cfg, g=g, **a),
    "b4": lambda: reverse_tile(nt, cfg, rec, g),
}
for key, fn in timed.items():
    cs.cuda_ms(fn, 2)
    print(f"RESULT {name} {key}_scene0 {cs.cuda_ms(fn, 10):.4f} ms (mean of 10)", flush=True)
del rec

def fwd_bwd(key):
    m = mats.clone().requires_grad_()
    vals, _ = render_samples(m, scene, key, cfg, device=dev)
    tonemap_mean(vals, cfg.spp).mean().backward()
    return m.grad

n_values = cfg.width * cfg.height * 3
tile_post = lambda vals, start: tonemap_mean(vals, cfg.spp).sum() / n_values
lgr = lambda key: loss_and_grad_range(mats, scene, key, cfg, 0, cfg.n_samples, tile_post,
                                      device=dev)
fwd = lambda key: render_samples(mats, scene, key, cfg, device=dev)
paths = (("forward", fwd), ("fwd_bwd", fwd_bwd), ("loss_and_grad_range", lgr))
for what, fn in paths:
    fn(1)
    for r in range(3):
        print(f"RESULT {name} {what}_run{r} {cs.cuda_ms(lambda: fn(r + 2), 1):.3f} ms", flush=True)

if profile:
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    lgr(8)
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lgr(7)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    dev_ev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    print(f"  profile {name} loss_and_grad_range: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%)", flush=True)
    for e in sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} {e.key[:90]}",
              flush=True)
    cpu_ev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(cpu_ev, key=lambda e: -e.self_cpu_time_total)[:16]:
        print(f"    host {e.self_cpu_time_total / 1e3:9.3f} ms x{e.count:<5d} {e.key[:90]}",
              flush=True)
    waits = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaMemcpyAsync",
             "aten::_local_scalar_dense", "aten::item", "aten::nonzero", "cudaMalloc", "cudaFree",
             "cudaMemsetAsync", "cudaLaunchKernel", "aten::bitwise_xor", "aten::sqrt")
    print("    calls: " + ", ".join(f"{w} {sum(e.count for e in ev if e.key == w)}" for w in waits),
          flush=True)
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    print(f"RESULT {name} lgr_kernel_launches {launches} per call "
          f"({launches / (cfg.n_samples / (1 << 20)):.1f} per 2^20 rays)", flush=True)
    # The same paths again in this process, after the profiler has run.
    for what, fn in paths:
        for r in range(3):
            print(f"RESULT {name} {what}_after_profile_run{r} "
                  f"{cs.cuda_ms(lambda: fn(r + 2), 1):.3f} ms", flush=True)

if large:
    big = large_scene(dev)
    rays_b = cs.tile_inputs(big, cfg, 0, n, dev, external=False)
    ab = cs.camera_launch(n, 0) if camera_mode else rays_b
    tabs = pack_tables(big, big.diffuse, cfg)
    gb = torch.rand((3, n), generator=torch.Generator().manual_seed(9)).to(dev)
    rb1, sb1 = render_tile(big.diffuse, big, cfg, tables=tabs, **ab)
    rb3, sb3, rec_b = render_tile_rec(big.diffuse, big, cfg, tables=tabs, **ab)
    same = torch.equal(rb3, rb1) and torch.equal(sb3, sb1)
    print(f"  {name}: clustered B3 = B1 on the large launch {same}", flush=True)
    d4b = reverse_tile(big.n_tri, cfg, rec_b, gb)
    ok4b = cs.grad_close(d4b, reverse_tile_plain(big.n_tri, cfg, rec_b, gb))
    print(f"  {name}: B4 on the large launch's B3 records within tolerance {ok4b}, twice "
          f"bit-equal {torch.equal(reverse_tile(big.n_tri, cfg, rec_b, gb), d4b)}, digest "
          f"{digest(d4b)}", flush=True)
    if not ok4b:
        raise SystemExit(f"{name}: B4 disagrees with its plain version on the large launch")
    fn = lambda: reverse_tile(big.n_tri, cfg, rec_b, gb)
    cs.cuda_ms(fn, 2)
    print(f"RESULT {name} b4_large {cs.cuda_ms(fn, 10):.4f} ms (mean of 10)", flush=True)
    del rec_b
    m = big.diffuse
    jobs = [("b3_large", lambda: render_tile_rec(m, big, cfg, tables=tabs, **ab)),
            ("b2_large", lambda: grad_tile(m, big, cfg, g=gb, tables=tabs, **ab))]
    if camera_mode:  # the same kernels fed camera_rays' rays
        jobs += [("b3_large_rays", lambda: render_tile_rec(m, big, cfg, tables=tabs, **rays_b)),
                 ("b2_large_rays", lambda: grad_tile(m, big, cfg, g=gb, tables=tabs, **rays_b))]
    for key, fn in jobs:
        fn()
        print(f"RESULT {name} {key} {cs.cuda_ms(fn, 5):.4f} ms (mean of 5, clusters of "
              f"{tabs.cluster_k})", flush=True)
    from inverse_path_tracer_torch.ops.kernels.render_kernel import CAR_ALIVE
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        init_tile, stage_reverse_tile, stage_reverse_tile_plain, stage_tile)
    from inverse_path_tracer_torch.render.forward import _binned_order, _scene_bins
    k = cfg.stage_bounces
    carry = init_tile(m, big, cfg, rays_b["p"], rays_b["d"], rays_b["alive"], tables=tabs)
    order = _binned_order(carry, *_scene_bins(big, cfg), cfg.bin_cells)
    carry, orig = carry[:, order].contiguous(), rays_b["orig"][:, order].contiguous()
    live = (carry[CAR_ALIVE] > 0).sum(dtype=torch.int32).reshape(1)
    _, rec0 = stage_tile(m, big, cfg, carry, orig, 0, k, keys=rays_b["keys"], with_rec=True,
                         tables=tabs, live=live)
    del carry, rays_b
    suf = torch.zeros((4, n), device=dev)
    dm_p, suf_p = stage_reverse_tile_plain(big.n_tri, cfg, k, rec0, gb, suf)
    dm, suf_o = stage_reverse_tile(big.n_tri, cfg, k, rec0, gb, suf)
    dm2, _ = stage_reverse_tile(big.n_tri, cfg, k, rec0, gb, suf)
    ok9 = cs.grad_close(dm, dm_p) and bool(torch.allclose(suf_o, suf_p, rtol=1e-5, atol=1e-6))
    print(f"  {name}: B9 on the large launch's stage-0 records within tolerance {ok9}, twice "
          f"bit-equal {torch.equal(dm, dm2)}, digest {digest(dm, suf_o)}, "
          f"{getattr(stage_reverse_tile, 'blocks', '-')} blocks", flush=True)
    if not ok9:
        raise SystemExit(f"{name}: B9 disagrees with its plain version")
    fn = lambda: stage_reverse_tile(big.n_tri, cfg, k, rec0, gb, suf)
    cs.cuda_ms(fn, 2)
    print(f"RESULT {name} b9_large_stage0 {cs.cuda_ms(fn, 10):.4f} ms (mean of 10)", flush=True)
    del rec0

    def fwd_bwd_large(key):
        mm = m.clone().requires_grad_()
        vals, _ = render_samples(mm, big, key, cfg, device=dev)
        tonemap_mean(vals, cfg.spp).mean().backward()
        return mm.grad

    fwd_bwd_large(1)
    for r in range(2):
        print(f"RESULT {name} fwd_bwd_large_run{r} "
              f"{cs.cuda_ms(lambda: fwd_bwd_large(r + 2), 1):.3f} ms", flush=True)
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        fwd_bwd_large(7)
        torch.cuda.synchronize()
    b9 = [e for e in prof.key_averages() if "stage_reverse_kernel" in e.key]
    print(f"RESULT {name} b9_in_fwd_bwd_large "
          f"{sum(e.self_device_time_total for e in b9) / 1e3:.3f} ms over "
          f"{sum(e.count for e in b9)} launches (profiler on)", flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one loss_and_grad_range per tree")
    ap.add_argument("--large", action="store_true",
                    help="also time clustered B2 and B3 on the large scene's first launch")
    ap.add_argument("--after-smoke", action="store_true",
                    help="run the tree's chip_smoke.py phases 3-7 first, in the same process")
    ap.add_argument("--once", action="store_true",
                    help="launch B3 and B2 once each on scene 0 and nothing else")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip(), flush=True)
    rc = 0
    for tree in args.trees:
        flags = ["1" if f else "0"
                 for f in (args.profile, args.large, args.after_smoke, args.once)]
        proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree), *flags])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

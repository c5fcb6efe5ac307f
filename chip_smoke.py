#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inverse_path_tracer_torch) on one GPU.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits nonzero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources here (render_fwd.cu: B1 and
     B3, the template render_kernel<kRecords, kSweep>, B7, B8 and B10's
     own launch; render_bwd.cu: B2, B4 and B9; inverse.cu: B5 and B6's two
     sinks; reorder.cu: the staged re-sort; every kernel sweeps through B10
     in render_common.cuh, and B1, B2, B3 and B10's launch also search by
     the BVH traversal there, the flavour kSweep = 2), one nvcc per source, in parallel; ptxas's report,
     with no spill allowed in any kernel;
  3. each kernel against its plain PyTorch version on the card, on the
     scene-0 fixture at 64x64/4 spp/8 bounces: external uniforms with quirks
     on and off, the fused RNG, a specular (Ks > 0) variant and a small
     vertex-normal mesh (242 triangles: clustered, then again with the
     dense sweep, CLUSTER_MIN_TP raised).  Radiance and records rtol 1e-4 / atol 1e-5 and
     equal ray counts; B3's radiance and counts equal B1's; gradients rtol
     1e-4 with an absolute floor of 1e-6 of the largest entry (the kernels
     and the plain one-hot contraction sum in different orders); the
     vertex-normal scene under the knife-edge bounds of the JAX tests; on
     the fused cases the kernels in camera mode (the primary rays made in
     the kernel, as the fused paths run them): B1 bit-equal to B1 fed the
     plain camera_rays' rays, B3 = B1, B2 twice bit-equal and equal to B2
     on those rays; B4 twice bit-equal;
  4. the forward main path, render_samples on scene 0 at 512x512, 64 spp,
     16 bounces (the bench configuration), fused RNG: launch counts, then
     one warm-up and 3 runs timed with CUDA events, rays/s with rays =
     segments + shadow rays; a profile with its kernel launches a call,
     which fails if a camera_rays op (CAMERA_OPS) ran: the kernels make the
     primary rays on every fused main path (phases 4, 6, 7, 12, 13, 20);
  5. the golden gate: scene 0 at 500x500/100 spp/16 bounces with the
     reference cube Kd against artifacts/bench_golden_0.png (mean |d| <
     5/255, p99 < 25/255);
  6. the fwd+bwd main path: the same configuration, loss =
     tonemap_mean(vals, spp).mean() (bench.py:148-151), loss.backward()
     through B1 and B2: launch counts, a finite nonzero gradient, 1 warm-up
     and 3 timed runs, rays/s, a profile;
  7. loss_and_grad_range (B3 + B4) on the same configuration with a
     per-launch loss that sums to the loss above: its gradient equals
     autograd's (rtol 1e-5); timed; a profile that prints its kernel
     launches a call and B4's share of its device time;
  8. the finite-difference gate of bench.py:196-236: 64x64/16 spp/8
     bounces, fused RNG, eps 2e-2 along the gradient: ratio in (0.98,
     1.02); a random direction's ratio is printed;
  9. recovery: recover_materials on scene 0 at 64x64/8 spp/8 bounces, 30
     Adam steps at lr 0.1 against a render at the true Kd with another key:
     last loss < 0.75 x first and Kd error < 0.7 x the start's
     (tests/test_utils.py:66-71); ms per step; then 3 steps, a checkpoint
     and a resume to 6, bit-equal to 6 uninterrupted steps;
 10. per-kernel timing at the main path's launch shape, in camera mode,
     beside its bound and its plain version; there B3's whole record array
     against its plain version (the slots past each ray's last bounce
     exactly 0 in both), B3's radiance and counts equal to B1's, B1 bit-equal
     to B1 fed the plain camera_rays' rays, B2 and B4 bit-equal across two
     calls, the persistent grids of B1, B2 and B3, and the bytes of the
     32-byte sectors that B4's loads fetch;
 11. B5 (dense edge grid) and B6 (edge records, and the global-grid sink)
     against their plain versions at 64x64/4 spp/8 bounces: scene 0 and
     the specular variant (B5 and B6), the vertex-normal scene (B6;
     clustered, and dense as in phase 3) and the large scene (B6,
     clustered), external uniforms and the fused RNG.  Grids against their
     plain versions rtol 1e-4 with an absolute floor of 1e-6 of the largest
     entry (atomics add in no fixed order) and equal visit counts; records:
     the hit and nee_ok rows equal, the other rows within rtol 1e-4 / atol
     1e-5 where their mask is set; B5's grid against B6's records reduced by
     grids_from_edge_records, the same tolerance; B6's float64 global grid
     against them within rtol 1e-9 and a floor of 1e-12 of the largest
     entry (GRID64_RTOL: the same float32 quantities, float64 sums in
     another order), with B5's float32 grid's reading at that measure; on
     the fused cases the kernels in camera mode with the target image in
     place of the pixel colours: records bit-equal and grids within those
     tolerances of the same kernels on the plain camera_rays' rays;
 12. the extraction main path at the reference dataset configuration: scene
     0 at 500x500/100 spp/16 bounces, fused RNG, extract_graph through B5
     (24 launches of 2^20 samples): 1 warm-up and 3 timed runs, rays/s, a
     profile; gates: no NaN, visited rows of w sum to 1 within 1e-5, the eye
     row nonzero on exactly triangles 0-17 and 20-23, eye-row pixel colours
     within 0.03 of artifacts/exp100/data.npz[0], and gcn0_params.npz on the
     port's graph predicting Kd with mean |error| < 0.05;
 13. the vertex-normal scene (242 triangles) extracted at the same
     configuration through B6's global-grid sink: no launch of the records
     sink, no NaN, visited rows summing to 1, 1 warm-up and 3 timed runs, a
     profile with no aten::nonzero and B6's share of the device time.  No
     main path runs B6's records sink: its launch count is 0, and phase 15
     holds it against its plain version;
 14. train_gcn from a fresh init on the port's scene-0 graph (2000 Adam
     steps at lr 1e-4; last L1 < first), then render_with_materials with
     gcn0's prediction at 500x500/100 spp and its PSNR against the target;
 15. B5 at the first 2^20-ray launch of scene 0's extraction and B6 (both
     sinks) at the first of the vertex-normal scene's, B5 and the records
     against their plain versions and the global grid against the records
     reduced on those inputs (16 bounces), each timed beside its plain
     version and its bound;
 16. the large scene (assets.large_scene: the box plus a 1280-triangle
     sphere, 1298 triangles, clustered at the auto width) at 64x64/4 spp/8
     bounces, fused RNG and external uniforms: B7, B8 (stages 0 and 1,
     records; per-lane and with the live-lane count of the staged
     orchestration) and B10 against their plain versions, exact on the flat
     variant and within the vertex-normal bounds of phase 3 on the other
     (the plain stages start from the kernel's carries); B7 in camera mode
     bit-equal to B7 on the plain camera_rays' rays and across two calls,
     on its persistent grid; B9 on B8's records
     within the gradient tolerance and bit-equal across two calls on its
     persistent grid; staged against mega on the card, bit
     for bit with equal counts on the flat scene and scene 0; then a flat
     scene whose sweep tables exceed a block's shared memory (the box plus a
     3840-triangle sphere), so that the clustered kernels read their planes
     through L1: B1, B7 and B8 (both stages, per lane and with the live-lane
     count) against their plain versions, bit for bit;
 17. clustered B1-B4 and B6 (both sinks) on the flat large scene against the plain
     versions of the dense sweep in global order (radiance, counts and
     records equal, triangle rows mapped back; gradients and grids within
     their tolerances, the global grid within phase 11's float64 one), and
     B5 with clusters of 8 on scene 0;
 18. the large-scene main path, the vertex-normal scene at 512x512/64
     spp/16 bounces, fused RNG, wavefront "auto" (staged): render_samples
     with the launches of B7, B8 and B10 (one warm-up, 3 timed runs, rays/s,
     a profile with B8's sum over the render) and the same forward at
     wavefront="mega" (2 timed runs); the forward at each cluster width of
     WIDTHS (2 timed runs each), the fastest printed beside the auto width;
     fwd+bwd through the staged autograd Function (B7, B8 and B9 launches; 1
     warm-up, 2 timed runs, a profile); loss_and_grad_range staged, its
     gradient equal to autograd's (rtol 1e-5), 2 timed runs;
 19. the finite-difference gate of phase 8 on the large vertex-normal scene
     through the staged gradient;
 20. the large vertex-normal scene extracted at 500x500/100 spp/16 bounces
     through clustered B6's global-grid sink, as phase 13;
 21. B7 (camera mode, persistent, bit-equal across two calls), B8 (stages
     0 to 3, with the live-lane count) and B9 (persistent, bit-equal across
     two calls) at the first 2^20-ray launch of the large render, each
     against its plain version
     there and timed beside its bound (bounds count the pairs and box tests
     the plain version's sweeps did); B7 and B1 in camera mode against the
     same kernels fed the plain camera_rays' rays; B10 as B1 on that launch
     with clustered tables at the auto
     width and at JAX's 768 against dense tables, with the (ray, group) and
     (ray, cluster) box tests and the shares that entered; for B7 (also
     at the launch from sample 11 * 2^20, where the camera rays meet the
     sphere, timed), each B8 stage, B1 and B6 at the large extraction's
     first launch, the pairs that the plain version's per-lane loop needs
     and B10 sweeps on its rays (intersect_tile's counts: group box tests
     equal, cluster box tests and pairs no fewer), and the pair loop's
     lane-slots of each, with each one's SIMT efficiency (the pairs needed
     over its slots); clustered B2, B3
     and B4 (on B3's records) on that launch and clustered B6 (both sinks)
     on the first launch of the
     large extraction, timed; ptxas's registers and spills of the clustered
     kernels;
 22. batched recovery (recover_materials_batched, B1 and B2) at BASELINE
     config #4: scenes 0-15 (asserted to share scene 0's vertices) at
     256x256/64 spp/16 bounces, targets rendered with each scene's labels
     under other keys, 30 Adam steps at lr 0.1 from theta = 0: last loss <
     0.75 x first and mean Kd error < 0.7 x the start's; ms per step
     (synchronized wall clock, median) and rays/s over the batch; 2 steps
     over all 100 scenes from artifacts/exp100/gcn_init_256.npy, timed, its
     sigmoid(theta) at step 0 within 1e-6 of the clipped init; at
     64x64/8 spp/8 bounces with 4 scenes, scene_chunk 0, 1 and 3
     bit-identical, a resume at step 4 of 8 inside the averaging window
     (average_last 6) bit-identical, and n_keys 2 finite;
 23. the CLI on the card: python3 -m inverse_path_tracer_torch.cli render
     --profile at 512x512/64 spp in a subprocess (PNG and trace written),
     then through cli.main, without --cpu, generate, render, extract-graph
     (B5), train-gcn, evaluate (this CLI's checkpoint and gcn0_params.npz),
     graph-viz (counts against artifacts/graphviz), recover, recover-batch
     and make-dataset, each timed with the kernel launches it made;
 24. the native bridge and the BVH (ops/bvh.py, utils/native.py) on the
     large scene: the library builds with g++ from native/src; native and
     Python OBJ parses and BVH builds equal (host ms of each); intersect_bvh
     on 2^20 rays on the card (the large render's first camera launch, and
     random rays from inside the box) with the dense plain sweep's hits (t
     rtol 1e-5), timed beside B10 alone (intersect_tile, clustered) and the
     dense plain sweep; the render at 64x64/4 spp/8 bounces of the scene
     with its BVH attached, bit-equal to the scene without it and through
     the kernels (counted: with intersect "auto" the renders do not read
     the BVH);
 25. sharded rendering and recovery (parallel/shard.py) on the main path at
     512x512/64 spp/16 bounces: a process group of one rank (NCCL) in this
     process, render_samples_sharded bit-equal to render_samples and a
     sharded recovery step against recover_step (loss rtol 1e-6, gradient
     rtol 1e-5 / atol 1e-8), each timed, B1 and B2 counted; two processes
     on the one card (gloo; this script with --shard-worker), started at
     once: the gathered radiance and counts bit-equal to one rank's, theta
     bit-identical on both ranks after 3 steps and within the bars of one
     rank's, wall times; then two processes of cli recover --shard
     --coordinator at 64x64/8 spp, their --out bit-identical;
 26. the experiment modules (inverse_path_tracer_torch/experiments): the
     gate on scene 0 at 256x256, B10 alone (intersect_tile) on the gate's
     rays bit-equal to its plain version in (t, triangle, hit), the
     direct-pixel counts equal and the gate triangles 0-15 and 20-23 (the
     JAX run's); recover100 on all 100 scenes at 256x256/64 spp/16 bounces
     from the GCN of artifacts/exp100/gcn_params.npz (100 renders and B5
     extractions at 500x500/100 spp), 3 steps at lr 1e-2, then the gate and
     the hybrid; full_pipeline on 4 scenes at 500x500/100 spp (2000 GCN
     epochs for train and train0, 2 scenes evaluated, recovery of 4 scenes
     x 5 steps).  Both with every plain version refused, the launches of
     B1, B2, B5 and B10 counted from 0 and required, finite results of the
     expected shapes, the gate, the recovery's loss lower after its 3 steps
     than before, and each module's phase seconds;
 27. (run after phase 24) the BVH route (RenderConfig intersect="bvh") on
     the 20,498-triangle scene (assets.bvh_scene): the traversal kernel on
     2^20 rays against the plain intersect_bvh and B10's clustered sweep
     (hit and t bit for bit, triangles equal but for exact ties, the work
     counts equal), timed with its bound; B1's BVH instance timed at the
     1298-triangle scene's first 2^20-sample launch beside B1 clustered;
     the route against the clustered
     mega route at 64x64/4 spp/8 bounces; B2, B4 and B9 past 2048 triangles
     (accumulators in global memory) against their plain versions and twice
     bit-equal; the FD gate; forward, fwd+bwd and loss_and_grad_range at
     512x512/64 spp/16 bounces on both routes, a profile of the route
     (bvh_route_phase);
 28. (run after phase 21) the staged re-sort (reorder.cu, reorder_tile) at
     the large render's first 2^20-lane launch: at each of its 4 stages,
     binned and alive first, order, carry, orig and live bit-equal to its
     plain version (the PyTorch sort and gathers), each stage timed beside
     its byte bound and the plain chain; a 500x500/100 spp render of the
     scene counts 96 launches (reorder_phase).

The kernels' JSON object, then the card's name and power limit, then, last,
{"ok": true, "device": {...}}.  Needs CUDA; exits nonzero without it.
About 5 minutes on the H100, the build included.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations of render_fwd.cu's triangle test per (ray, triangle): the
# face plane is two 3-term dot products (one with the offset), a negate and
# a divide; each edge plane is two 3-term dot products and a + t*b.
FACE_PLANE_OPS = 5 + 6 + 2
EDGE_PLANE_OPS = 5 + 6 + 2
# f32 operations of a (ray, box) slab test (render_common.cuh enters): 6
# subtractions, 6 multiplies and 10 min/max.
BOX_OPS = 6 + 6 + 10
# Bytes of a lane's carry (render_kernel.py CARRY_ROWS float32 rows).
CARRY_ROWS_BYTES = 24 * 4
# A block's opt-in dynamic shared memory on the H100 (render_common.cuh
# kMaxSmem).
SMEM_OPT_IN = 232448
# The cluster widths phase 18 times the large forward at: this card's auto
# width (16), the widths between it and JAX's, and JAX's auto width (768).
WIDTHS = (16, 32, 64, 128, 768)

CHECK = dict(width=64, height=64, spp=4, max_bounces=8)
MAIN = dict(width=512, height=512, spp=64, max_bounces=16)
GOLDEN = dict(width=500, height=500, spp=100, max_bounces=16)
FD = dict(width=64, height=64, spp=16, max_bounces=8, tile_size=1 << 14)
RECOVER = dict(width=64, height=64, spp=8, max_bounces=8)
# BASELINE.json config #4: batched recovery of the reference scenes.
BATCH = dict(width=256, height=256, spp=64, max_bounces=16)
# Kernel name -> (source, the TPU kernel it replaces).
KERNELS = {
    "render_fwd": ("render_fwd.cu", "inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1440"),
    "render_fwd_rec": ("render_fwd.cu",
                       "inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1571"),
    "render_bwd_grad": ("render_bwd.cu",
                        "inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1505"),
    "render_bwd_reverse": ("render_bwd.cu",
                           "inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1640"),
    "inverse_grid": ("inverse.cu", "inverse_path_tracer_tpu/ops/pallas/inverse_kernel.py:271"),
    "inverse_rec": ("inverse.cu", "inverse_path_tracer_tpu/ops/pallas/inverse_kernel.py:338"),
    "inverse_global": ("inverse.cu", "inverse_path_tracer_tpu/ops/pallas/inverse_kernel.py:338"),
    "init_tile": ("render_fwd.cu", "inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1677"),
    "stage_tile": ("render_fwd.cu", "inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1711"),
    "stage_reverse_tile": ("render_bwd.cu",
                           "inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1780"),
    "cluster_sweep": ("render_common.cuh",
                      "inverse_path_tracer_tpu/ops/pallas/render_kernel.py:404"),
    # No Pallas counterpart: the JAX package's BVH route is XLA code.
    "bvh_traversal": ("render_common.cuh", "inverse_path_tracer_tpu/ops/bvh.py:155"),
}
# f32 operations of the suffix recursion per reached bounce (render_bwd.cu
# reverse_path): ct = pm*suf*(coeff/pi) + g*pm*nee (3+3+1+3+3+3), suf =
# g*c + f*suf (9), and the 3 adds of the warp sum into d materials.
RECURSION_OPS = 28
# Bytes of the global-grid sink's float64 adds per edge (9 quantities).
N_QUANT_BYTES = 9 * 8
GOLDEN_PNG = os.path.join(REPO, "artifacts", "bench_golden_0.png")
EXP100 = os.path.join(REPO, "artifacts", "exp100")
# The eye row of the JAX package's extraction of the in-repo fixture
# (500x500 at 4 and at 16 spp): nonzero on exactly these triangles.
EYE_VISIBLE = list(range(18)) + [20, 21, 22, 23]


def log(*a):
    print(*a, flush=True)


def shape(cfg) -> str:
    return f"{cfg.width}x{cfg.height}/{cfg.spp}spp/{cfg.max_bounces}b"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_label(mangled: str) -> str:
    """A readable name of a kernel of this package from its mangled one,
    e.g. stage_kernel<false, true>."""
    m = re.match(r"_ZN(\d+)", mangled)  # the anonymous namespace, then the name
    if not m or not mangled[m.end():].startswith("_GLOBAL__N"):
        return mangled
    pos = m.end() + int(m.group(1))
    m = re.match(r"\d+", mangled[pos:])
    if not m:
        return mangled
    end = pos + m.end() + int(m.group(0))
    name, rest = mangled[pos + m.end() : end], mangled[end:]
    args = re.match(r"I((?:L[bi]\d+E)+)E", rest)
    if not args:
        return name
    vals = [{"b0": "false", "b1": "true"}.get(t + v, v)
            for t, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
    return f"{name}<{', '.join(vals)}>"


def ptxas_report(log: str):
    """[(kernel, registers, spill store bytes, spill load bytes, stack
    bytes)] from the output of nvcc -Xptxas -v."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": kernel_label(m.group(1))}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return [(k["kernel"], k.get("registers"), k.get("spill_stores"), k.get("spill_loads"),
             k.get("stack")) for k in out]


def fixture(device, cube_kd=None):
    import torch

    from inverse_path_tracer_torch import ASSET_ROOT, load_scene

    scene = load_scene(os.path.join(REPO, "scenes", "0.txt"), asset_root=ASSET_ROOT)
    mats = scene.diffuse.clone()
    if cube_kd is not None:
        mats[18:] = torch.tensor(cube_kd, dtype=torch.float32)
    return scene.to(device), mats.to(device)


def variant_scenes(device):
    """(name, scene, materials) for the specular and vertex-normal checks,
    built from files written under build/chip_smoke/."""
    from inverse_path_tracer_torch import ASSET_ROOT, build_scene
    from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
    from inverse_path_tracer_torch.scene.dsl import ObjectParams

    os.makedirs(OUT_DIR, exist_ok=True)
    spec_mtl = os.path.join(OUT_DIR, "spec.mtl")
    with open(spec_mtl, "w") as f:
        f.write("newmtl cube\nKd 0.5 0.3 0.2\nKs 0.4 0.4 0.4\nNs 16\n")
    sphere = os.path.join(OUT_DIR, "sphere.obj")
    with open(sphere, "w") as f:
        f.write(sphere_obj_text(rings=8, segments=16))
    box = ObjectParams(pos=(0, 0, 4), scl=(2, 2, 2),
                       obj_file="CornellBox/CornellBox-Empty-CO.obj",
                       mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    spec = build_scene([box, ObjectParams(pos=(0, -1.5, 4), obj_file="shapes/cube.obj",
                                          mtl_file=spec_mtl)], asset_root=ASSET_ROOT)
    if spec.specular_idx.shape[0] == 0:
        raise AssertionError("the specular variant has no Ks > 0 triangle")
    vn = build_scene([box, ObjectParams(pos=(0, -1.5, 4), obj_file=sphere,
                                        mtl_file="*Kd 0.5 0.5 0.5*")], asset_root=ASSET_ROOT)
    if not vn.has_vertex_normals:
        raise AssertionError("the sphere variant has no vertex normals")
    return [("specular", spec.to(device), spec.diffuse.to(device)),
            ("vertex_normals", vn.to(device), vn.diffuse.to(device))]


@contextlib.contextmanager
def sweep_layout(dense: bool):
    """Within the block, every scene takes the dense sweep when `dense`
    (ops/kernels/clusters.py CLUSTER_MIN_TP raised past any scene); the
    package's own threshold otherwise."""
    from inverse_path_tracer_torch.ops.kernels import clusters

    own = clusters.CLUSTER_MIN_TP
    if dense:
        clusters.CLUSTER_MIN_TP = 1 << 30
    try:
        yield
    finally:
        clusters.CLUSTER_MIN_TP = own


def camera_launch(n, key, base=0):
    """The fused paths' inputs of a launch of n samples from `base`: the
    kernels make the primary rays themselves (camera mode) under `key`."""
    from inverse_path_tracer_torch.ops import rng
    from inverse_path_tracer_torch.ops.camera import Camera

    return dict(camera=Camera(base, n, key), keys=rng.key_words(key))


def tile_inputs(scene, cfg, key, n, device, external):
    """Rays of the first n samples and either external uniforms (seeded
    torch.rand) or fused-RNG key words."""
    import torch

    from inverse_path_tracer_torch.ops import rng
    from inverse_path_tracer_torch.render.forward import camera_rays

    idx = torch.arange(n, dtype=torch.int64, device=device)
    p, d = camera_rays(scene, cfg, key, idx)
    args = dict(p=p.T.contiguous(), d=d.T.contiguous(),
                alive=torch.ones((1, n), dtype=torch.float32, device=device),
                orig=idx.to(torch.int32)[None, :].contiguous())
    if external:
        g = torch.Generator(device="cpu").manual_seed(key)
        args["uniforms"] = torch.rand((cfg.max_bounces * 8, n), generator=g).to(device)
    else:
        args["keys"] = rng.key_words(key)
    return args


def grad_close(got, want) -> bool:
    import torch

    return bool(torch.allclose(got, want, rtol=1e-4, atol=1e-6 * float(want.abs().max())))


def vn_grad_close(got, want) -> bool:
    """The JAX tests' bound for a vertex-normal scene's gradient
    (tests/test_pallas.py:263-270): at most 6 triangle rows differ, the
    totals agree to 1e-3 and the L1 difference is under 1e-2 of the L1 mass."""
    import torch

    rows_off = int((~torch.isclose(got, want, rtol=2e-4, atol=1e-7).all(dim=1)).sum())
    totals = torch.allclose(got.sum(0), want.sum(0), rtol=1e-3)
    bulk = float((got - want).abs().sum()) <= 1e-2 * float(want.abs().sum()) + 1e-6
    return rows_off <= 6 and totals and bulk


def check_kernel_vs_plain(device):
    """Phase 3: every kernel against its plain version on the card.  Returns
    the largest |kernel - plain| of each kernel over the flat cases."""
    import torch

    from inverse_path_tracer_torch import RenderConfig
    from inverse_path_tracer_torch.ops.kernels.clusters import kernel_perm
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        grad_tile,
        grad_tile_plain,
        render_tile,
        render_tile_plain,
        render_tile_rec,
        render_tile_rec_plain,
        reverse_tile,
        reverse_tile_plain,
    )

    cfg0 = RenderConfig(**CHECK)
    scene0, mats0 = fixture(device)
    cases = [
        ("external_quirks", scene0, mats0, cfg0, True),
        ("external_no_quirks", scene0, mats0, cfg0.with_(reference_quirks=False), True),
        ("fused", scene0, mats0, cfg0, False),
    ]
    variants = variant_scenes(device)
    cases += [(name, s, m, cfg0, False) for name, s, m in variants]
    # The vertex-normal mesh pads to 248 triangles and is clustered; the
    # dense instances of the kernels are held on it with the dense sweep.
    cases += [(f"{name}_dense", s, m, cfg0, False) for name, s, m in variants
              if name == "vertex_normals"]
    worst = dict.fromkeys(KERNELS, 0.0)
    for name, scene, mats, cfg, external in cases:
        with sweep_layout(name.endswith("_dense")):
            a = tile_inputs(scene, cfg, 11, cfg.n_samples, device, external)
            g = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(3))
            g = g.to(device)
            rk, sk = render_tile(mats, scene, cfg, **a)
            rp, sp = render_tile_plain(mats, scene, cfg, **a)
            rr, sr, rec = render_tile_rec(mats, scene, cfg, **a)
            _, _, rec_p = render_tile_rec_plain(mats, scene, cfg, **a)
            dk = grad_tile(mats, scene, cfg, g=g, **a)
            dp = grad_tile_plain(mats, scene, cfg, g=g, **a)
            perm = kernel_perm(scene, cfg)  # clustered scenes: the records' rows are internal
            d4 = reverse_tile(scene.n_tri, cfg, rec, g, perm)
            d4p = reverse_tile_plain(scene.n_tri, cfg, rec, g, perm)
            b4_same = torch.equal(reverse_tile(scene.n_tri, cfg, rec, g, perm), d4)
            if not external:  # the same rays made in the kernels (camera mode)
                cam = camera_launch(cfg.n_samples, 11)
                rc, sc = render_tile(mats, scene, cfg, **cam)
                r3c, s3c, _ = render_tile_rec(mats, scene, cfg, **cam)
                dc = [grad_tile(mats, scene, cfg, g=g, **cam) for _ in range(2)]
            torch.cuda.synchronize()
        if name.startswith("vertex_normals") and (perm is None) != name.endswith("_dense"):
            raise AssertionError(f"{name}: the sweep layout is not the one the case names")
        if not all(bool(torch.isfinite(t).all()) for t in (rk, rp, rec, dk, dp, d4, d4p)):
            raise AssertionError(f"{name}: non-finite output")
        errs = {"render_fwd": float((rk - rp).abs().max()),
                "render_fwd_rec": float((rec - rec_p).abs().max()),
                "render_bwd_grad": float((dk - dp).abs().max()),
                "render_bwd_reverse": float((d4 - d4p).abs().max())}
        seg_k, seg_p = float(sk[0].sum()), float(sp[0].sum())
        # B3 runs B1's arithmetic; B4 runs B2's recursion on the same records.
        same = torch.equal(rr, rk) and torch.equal(sr, sk)
        b4_is_b2 = bool(torch.allclose(d4, dk, rtol=1e-5, atol=0))
        b4_ok = grad_close(d4, d4p) and b4_is_b2 and b4_same
        if name.startswith("vertex_normals"):
            # Knife-edge bound (tests/test_pallas.py:219-223): grazing hits on
            # curved geometry may resolve differently within an ulp.
            close = torch.isclose(rk, rp, rtol=1e-4, atol=1e-5).all(dim=0).float().mean()
            rec_close = torch.isclose(rec, rec_p, rtol=1e-4, atol=1e-5).all(dim=0).float().mean()
            mean_d = float((rk - rp).abs().mean())
            ok = (close >= 0.97 and rec_close >= 0.97 and mean_d < 0.02
                  and abs(seg_k - seg_p) <= 1e-3 * seg_p + 8 and vn_grad_close(dk, dp))
            detail = (f"close lanes {float(close):.5f}, record lanes {float(rec_close):.5f}, "
                      f"mean |d| {mean_d:.3e}")
        else:
            ok = (torch.allclose(rk, rp, rtol=1e-4, atol=1e-5) and torch.equal(sk, sp)
                  and torch.allclose(rec, rec_p, rtol=1e-4, atol=1e-5) and grad_close(dk, dp))
            detail = f"counts equal {torch.equal(sk, sp)}"
            for k, e in errs.items():
                worst[k] = max(worst[k], e)
        ok = ok and same and b4_ok
        camera = ""
        if not external:
            # Camera mode: B1 bit-equal to B1 fed the plain camera_rays' rays,
            # B3 = B1, B2 twice bit-equal and equal to B2 on those rays.
            cam_ok = (torch.equal(rc, rk) and torch.equal(sc, sk) and torch.equal(r3c, rc)
                      and torch.equal(s3c, sc) and torch.equal(dc[0], dc[1])
                      and torch.equal(dc[0], dk))
            ok = ok and cam_ok
            camera = f"; camera mode: B1 = B1 on camera_rays' rays, B3 = B1, B2 = B2 {cam_ok}"
        log(f"check {name} ({'dense' if perm is None else 'clustered'}): max |kernel - plain| "
            f"B1 {errs['render_fwd']:.3e}, B3 records "
            f"{errs['render_fwd_rec']:.3e}, B2 {errs['render_bwd_grad']:.3e}, B4 "
            f"{errs['render_bwd_reverse']:.3e}; segments {seg_k:.0f} vs {seg_p:.0f}, {detail}, "
            f"B3 = B1 {same}, B4 = B2 within 1e-5 {b4_is_b2} (bit-equal {torch.equal(d4, dk)}), "
            f"B4 twice bit-equal {b4_same}"
            f"{camera} -> {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"a kernel disagrees with its plain version on {name}")
    return worst


def main_path(device):
    """Phase 4: the bench configuration through render_samples."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, render_samples
    from inverse_path_tracer_torch.ops.kernels.render_kernel import render_tile

    cfg = RenderConfig(**MAIN)
    scene, mats = fixture(device)
    render_tile.launches = 0
    vals, stats = render_samples(mats, scene, 0, cfg, device=device)
    torch.cuda.synchronize()
    launches = render_tile.launches
    if launches == 0:
        raise AssertionError("the main path did not launch render_fwd")
    if vals.shape != (cfg.n_samples, 3) or not bool(torch.isfinite(vals).all()):
        raise AssertionError(f"bad radiance: shape {tuple(vals.shape)}")
    mean = float(vals.mean())
    if not 0.05 < mean < 50.0:
        raise AssertionError(f"implausible mean radiance {mean}")
    log(f"main path {shape(cfg)}: {launches} launches of render_fwd, "
        f"segments {int(stats.segments)}, shadow rays {int(stats.shadow_rays)}, "
        f"mean radiance {mean:.5f}")
    render_samples(mats, scene, 1, cfg, device=device)  # warm-up
    for k in range(3):
        out = []
        t = cuda_ms(lambda: out.append(render_samples(mats, scene, k + 2, cfg, device=device)), 1)
        st = out[0][1]
        rays = int(st.segments) + int(st.shadow_rays)
        log(f"main path run {k}: {t:.3f} ms, rays {rays}, {rays / (t / 1e3):.6e} rays/s")

    profile_once("one render", lambda: render_samples(mats, scene, 7, cfg, device=device),
                 ops=CAMERA_OPS)
    return launches


# CPU ops of the plain camera_rays (the counter hash and the normalisation):
# a fused main path, whose kernels make the primary rays, calls none.
CAMERA_OPS = ("aten::bitwise_xor", "aten::__xor__", "aten::sqrt", "cudaLaunchKernel")


def profile_once(what, fn, ops=()):
    """Device time by kernel from torch.profiler over one call of fn:
    logged, and returned as {kernel: (ms, launches)} ({} when the profiler
    recorded no device time).  With `ops`, the calls of each named CPU op
    are logged too and returned beside: (kernels, {op: calls}).  With
    CAMERA_OPS among them, the call fails if any camera_rays op ran; the
    kernel launches of the call are logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = {
        e.key: (getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    }
    calls = {op: sum(e.count for e in events if e.key == op) for op in ops}
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        log("profile: the profiler recorded no device time (device busy share not measured)")
        kernels = {}
    else:
        log(f"profile ({what}, profiler on): wall {wall_ms:.3f} ms, device busy "
            f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
        for name, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
            log(f"  {ms:10.3f} ms  x{count:<5d} {name[:100]}")
    if not ops:
        return kernels
    log(f"profile ({what}): CPU op calls " + ", ".join(f"{k} {v}" for k, v in calls.items()))
    if "cudaLaunchKernel" in calls:
        log(f"profile ({what}): {calls['cudaLaunchKernel']} kernel launches a call")
    camera = sum(calls.get(op, 0) for op in CAMERA_OPS if op != "cudaLaunchKernel")
    if set(CAMERA_OPS) <= set(calls) and camera:
        raise AssertionError(f"{what} ran {camera} camera_rays ops: the rays are not made in the "
                             "kernels")
    return kernels, calls


def fwd_bwd_path(device):
    """Phase 6: loss.backward() through render_samples at the bench
    configuration (bench.py:147-171).  Returns the launch counts of B1 and
    B2 and the gradient at key 0."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, render_samples
    from inverse_path_tracer_torch.ops.kernels.render_kernel import grad_tile, render_tile
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    cfg = RenderConfig(**MAIN)
    scene, mats = fixture(device)

    def fwd_bwd(key):
        m = mats.clone().requires_grad_()
        vals, stats = render_samples(m, scene, key, cfg, device=device)
        tonemap_mean(vals, cfg.spp).mean().backward()
        return m.grad, stats

    render_tile.launches = grad_tile.launches = 0
    grad, stats = fwd_bwd(0)
    torch.cuda.synchronize()
    launches = {"render_fwd": render_tile.launches, "render_bwd_grad": grad_tile.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"the fwd+bwd path did not launch every kernel: {launches}")
    if not bool(torch.isfinite(grad).all()) or float(grad.abs().sum()) == 0.0:
        raise AssertionError("the gradient is not finite and nonzero")
    log(f"fwd+bwd {shape(cfg)}: {launches['render_fwd']} launches of render_fwd, "
        f"{launches['render_bwd_grad']} of render_bwd grad_tile; |grad|_1 "
        f"{float(grad.abs().sum()):.6e}, {int((grad != 0).any(dim=1).sum())} of {scene.n_tri} "
        f"triangles nonzero")
    fwd_bwd(1)  # warm-up
    for k in range(3):
        out = []
        t = cuda_ms(lambda: out.append(fwd_bwd(k + 2)), 1)
        st = out[0][1]
        rays = int(st.segments) + int(st.shadow_rays)
        log(f"fwd+bwd run {k}: {t:.3f} ms, forward rays {rays}, {rays / (t / 1e3):.6e} rays/s")
    profile_once("one fwd+bwd", lambda: fwd_bwd(7), ops=CAMERA_OPS)
    return launches, grad


def loss_and_grad_path(device, grad_ref):
    """Phase 7: loss_and_grad_range (B3 then B4 per launch) on the fwd+bwd
    configuration, with a per-launch loss whose sum is tonemap_mean(vals,
    spp).mean(); its gradient must equal autograd's."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, loss_and_grad_range
    from inverse_path_tracer_torch.ops.kernels.render_kernel import render_tile_rec, reverse_tile
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    cfg = RenderConfig(**MAIN)
    scene, mats = fixture(device)
    n_values = cfg.width * cfg.height * 3

    def tile_post(vals, start):
        return tonemap_mean(vals, cfg.spp).sum() / n_values

    def run(key):
        return loss_and_grad_range(mats, scene, key, cfg, 0, cfg.n_samples, tile_post,
                                   device=device)

    render_tile_rec.launches = reverse_tile.launches = 0
    loss, grad, stats = run(0)
    torch.cuda.synchronize()
    launches = {"render_fwd_rec": render_tile_rec.launches,
                "render_bwd_reverse": reverse_tile.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"loss_and_grad_range did not launch every kernel: {launches}")
    err = float(((grad - grad_ref).abs() / grad_ref.abs().clamp_min(1e-30)).max())
    ok = bool(torch.allclose(grad, grad_ref, rtol=1e-5, atol=0))
    log(f"loss_and_grad_range: {launches['render_fwd_rec']} launches of render_fwd_rec, "
        f"{launches['render_bwd_reverse']} of render_bwd reverse_tile; loss {float(loss):.7f}; "
        f"max rel |grad - autograd's| {err:.3e} (bit-equal {torch.equal(grad, grad_ref)}) "
        f"-> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("loss_and_grad_range's gradient differs from autograd's")
    run(1)  # warm-up
    for k in range(3):
        out = []
        t = cuda_ms(lambda: out.append(run(k + 2)), 1)
        st = out[0][2]
        rays = int(st.segments) + int(st.shadow_rays)
        log(f"loss_and_grad_range run {k}: {t:.3f} ms, {rays / (t / 1e3):.6e} rays/s")
    prof, calls = profile_once("one loss_and_grad_range", lambda: run(7),
                               ops=CAMERA_OPS + ("cudaMemsetAsync", "cudaMalloc", "cudaFree",
                                                 "cudaStreamSynchronize",
                                                 "aten::_local_scalar_dense"))
    log(f"loss_and_grad_range: {calls['cudaLaunchKernel']} kernel launches a call, "
        f"{calls['cudaLaunchKernel'] / (cfg.n_samples / (1 << 20)):.1f} per 2^20 rays")
    b4 = [(ms, count) for name, (ms, count) in prof.items() if "reverse_tile_kernel" in name]
    if b4:
        busy = sum(ms for ms, _ in prof.values())
        b4_ms = sum(ms for ms, _ in b4)
        log(f"loss_and_grad_range: B4 {b4_ms:.3f} ms in {sum(c for _, c in b4)} launches, "
            f"{100 * b4_ms / busy:.1f}% of its device time (profiler on)")
    return launches


def fd_gate(device, scene=None, mats=None, label="scene 0", cfg=None):
    """Phases 8, 19 and 27: central finite differences along the gradient
    (bench.py:196-236): ratio = <g, v> / FD_v in (0.98, 1.02), on scene 0
    or the given scene, at FD or the given config."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, render_samples
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    cfg = RenderConfig(**FD) if cfg is None else cfg
    if scene is None:
        scene, mats = fixture(device)

    def loss(m):
        vals, _ = render_samples(m, scene, 7, cfg, device=device)
        return tonemap_mean(vals, cfg.spp).mean()

    m = mats.clone().requires_grad_()
    loss(m).backward()
    g = m.grad
    eps = 2e-2

    def ratio(v):
        v = v / torch.linalg.norm(v)
        with torch.no_grad():
            fd = (float(loss(mats + eps * v)) - float(loss(mats - eps * v))) / (2 * eps)
        an = float((g * v).sum())
        return (an / fd if fd != 0 else float("inf")), an, fd

    r, an, fd = ratio(g)
    v_rand = torch.randn(mats.shape, generator=torch.Generator().manual_seed(12)).to(device)
    r_rand, _, _ = ratio(v_rand)
    ok = 0.98 < r < 1.02
    log(f"grad FD gate {label} {shape(cfg)} fused: along g analytic {an:.6e} fd {fd:.6e} ratio "
        f"{r:.5f}; random direction ratio {r_rand:.5f} -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"grad FD ratio {r:.5f} outside (0.98, 1.02)")
    return r, r_rand


def recovery(device):
    """Phase 9: recover_materials on scene 0 against a render at the true Kd
    (tests/test_utils.py:52-71 at 64x64/8 spp/8 bounces); then 6 steps
    with a checkpoint after 3 and a resume from it, which must equal 6
    uninterrupted steps bit for bit (the gradient goes through B2)."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, recover_materials, render_image

    cfg = RenderConfig(**RECOVER)
    scene, mats = fixture(device)
    target = render_image(mats, scene, 100, cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, losses = recover_materials(scene, target, cfg, steps=30, lr=0.1, key=1, device=device)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / 30
    err0 = float((0.5 - mats).abs().mean())
    err = float((rec - mats).abs().mean())
    ok = losses[-1] < 0.75 * losses[0] and err < 0.7 * err0
    log(f"recovery {shape(cfg)}, 30 steps lr 0.1: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
        f"({losses[-1] / losses[0]:.3f}x), Kd error {err0:.5f} -> {err:.5f} "
        f"({err / err0:.3f}x), {ms_step:.2f} ms per step -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("recovery missed its criteria")

    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, "recover_resume.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    run = lambda steps, **kw: recover_materials(scene, target, cfg, steps=steps, lr=0.1, key=1,
                                                device=device, **kw)
    whole, whole_losses = run(6)
    run(3, checkpoint_path=ckpt, checkpoint_every=3)
    resumed, tail_losses = run(6, checkpoint_path=ckpt, checkpoint_every=3, resume=True)
    same = torch.equal(resumed, whole) and tail_losses == whole_losses[3:]
    log(f"recovery resume: 3 steps, checkpoint, resume to 6 -> Kd bit-equal to 6 uninterrupted "
        f"steps {torch.equal(resumed, whole)}, losses of steps 3-5 equal "
        f"{tail_losses == whole_losses[3:]} -> {'OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("a resumed recovery differs from the uninterrupted one")
    return ms_step


def records_match(rec, rec_p):
    """B6 records: the hit and nee_ok rows equal; dst, src, w where hit and
    nee_w, e_idx where nee_ok within rtol 1e-4 / atol 1e-5.  Returns (ok,
    max |d| under the masks, bit-equal under the masks)."""
    import torch

    r, q = rec.view(-1, 8, rec.shape[1]), rec_p.view(-1, 8, rec.shape[1])
    ok = torch.equal(r[:, 2], q[:, 2]) and torch.equal(r[:, 4], q[:, 4])
    hit, nee = q[:, 2] > 0, q[:, 4] > 0
    err, same = 0.0, True
    for row, mask in ((0, hit), (1, hit), (3, hit), (5, nee), (6, nee)):
        a, b = r[:, row][mask], q[:, row][mask]
        if a.numel():
            err = max(err, float((a - b).abs().max()))
            ok = ok and bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
            same = same and torch.equal(a, b)
    return ok, err, same


def grid_match(got, want):
    """(ok, max |d|): grids within rtol 1e-4 with an absolute floor of 1e-6
    of the largest entry (atomics add in no fixed order) and visit counts
    equal."""
    import torch

    floor = 1e-6 * float(want.abs().max())
    ok = (bool(torch.allclose(got, want, rtol=1e-4, atol=floor))
          and torch.equal(got[..., 8], want[..., 8]) and bool(torch.isfinite(got).all()))
    return ok, float((got - want).abs().max())


# B6's float64 global grid against B6's records reduced on the same rays:
# the same float32 quantities summed in float64 in another order.  The
# tolerance: rtol 1e-9 with an absolute floor of 1e-12 of the largest entry.
# A grid summed in float32 (B5's) misses it by orders of magnitude.
GRID64_RTOL, GRID64_FLOOR = 1e-9, 1e-12


def grid64_gap(got, want) -> float:
    """The smallest rtol at which float64 grids agree under the absolute
    floor GRID64_FLOOR of the largest entry."""
    floor = GRID64_FLOOR * float(want.abs().max())
    excess = ((got.double() - want).abs() - floor).clamp_min(0)
    return float((excess / want.abs().clamp_min(1e-300)).max())


def grid64_match(got, want):
    """(ok, the gap of grid64_gap): within GRID64_RTOL, visit counts equal,
    finite."""
    import torch

    gap = grid64_gap(got, want)
    ok = (gap <= GRID64_RTOL and torch.equal(got[..., 8], want[..., 8])
          and bool(torch.isfinite(got).all()))
    return ok, gap


def check_inverse_vs_plain(device):
    """Phase 11: B5 and B6 (both sinks) against their plain versions on the
    card at 64x64/4 spp/8 bounces, scene 0, the specular variant, the
    vertex-normal scene (B6 alone: its grid does not fit B5; clustered, and
    again with the dense sweep) and the large scene (B6 clustered), each
    under external uniforms and the fused RNG; B5's grid against B6's
    records reduced (rtol 1e-4), B6's global grid against them (grid64_match).
    Returns the largest |kernel - plain| of each."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, large_scene
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        grids_from_edge_records,
        inverse_grid_fits,
        inverse_tile,
        inverse_tile_global,
        inverse_tile_plain,
        inverse_tile_rec,
        inverse_tile_rec_plain,
        unperm_grid,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables

    cfg = RenderConfig(**CHECK)
    scene0, _ = fixture(device)
    variants = variant_scenes(device)
    scenes = ([("scene0", scene0)] + [(name, s) for name, s, _ in variants]
              + [(f"{name}_dense", s) for name, s, _ in variants if name == "vertex_normals"]
              + [("large", large_scene(device))])
    worst = {"inverse_grid": 0.0, "inverse_rec": 0.0, "inverse_global": 0.0}
    for name, scene in scenes:
        for external in (True, False):
            with sweep_layout(name.endswith("_dense")):
                a = tile_inputs(scene, cfg, 21, cfg.n_samples, device, external)
                pix = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(22))
                pix = pix.to(device)
                tabs = pack_tables(scene, scene.diffuse, cfg)
                rec, st_r = inverse_tile_rec(scene, cfg, tables=tabs, **a)
                rec_p, st_p = inverse_tile_rec_plain(scene, cfg, **a)
                acc, st_g = inverse_tile_global(scene, cfg, pix=pix, tables=tabs, **a)
                acc_p, _ = inverse_tile_plain(scene, cfg, pix=pix, kernel_order=True, **a)
                reduced = grids_from_edge_records(rec, pix.T, scene, cfg, tabs.perm)
                if inverse_grid_fits(scene):
                    grid, st = inverse_tile(scene, cfg, pix=pix, **a)
                    grid_p, _ = inverse_tile_plain(scene, cfg, pix=pix, **a)
                if not external:  # camera mode: the rays and pixels read in the kernels
                    cam = camera_launch(cfg.n_samples, 21)
                    image = torch.rand((cfg.width * cfg.height, 3),
                                       generator=torch.Generator().manual_seed(23)).to(device)
                    pix_c = image[a["orig"][0].long() // cfg.spp].T.contiguous()
                    rec_c, st_rc = inverse_tile_rec(scene, cfg, tables=tabs, **cam)
                    acc_c, _ = inverse_tile_global(scene, cfg, image=image, tables=tabs, **cam)
                    acc_cr, _ = inverse_tile_global(scene, cfg, pix=pix_c, tables=tabs, **a)
                    cam_ok = (torch.equal(rec_c, rec) and torch.equal(st_rc, st_r)
                              and grid64_match(acc_c, acc_cr)[0])
                    if inverse_grid_fits(scene):
                        g5c, st5c = inverse_tile(scene, cfg, image=image, **cam)
                        g5r, _ = inverse_tile(scene, cfg, pix=pix_c, **a)
                        cam_ok = cam_ok and grid_match(g5c, g5r)[0] and torch.equal(st5c, st_r)
                torch.cuda.synchronize()
            if name.endswith("_dense") and tabs.cluster_k:
                raise AssertionError(f"{name}: the tables are clustered")
            ok, err_r, same = records_match(rec, rec_p)
            ok = ok and torch.equal(st_r, st_p)
            ok_g, err_g = grid_match(acc, acc_p)
            ok_gr, gap = grid64_match(unperm_grid(acc, tabs.perm), reduced)
            ok = ok and ok_g and ok_gr and torch.equal(st_g, st_p)
            line = (f"check inverse {name} {'external' if external else 'fused'}: B6 records "
                    f"max |d| {err_r:.3e} (bit-equal under masks {same}), counts equal "
                    f"{torch.equal(st_r, st_p)}; B6 global grid max |d| {err_g:.3e} of max "
                    f"{float(acc_p.abs().max()):.3e} (clusters {tabs.cluster_k}), = plain "
                    f"{ok_g}, = B6 records reduced {ok_gr} (rtol needed {gap:.1e}, bound "
                    f"{GRID64_RTOL:.0e}), counts equal {torch.equal(st_g, st_p)}")
            if not external:
                ok = ok and cam_ok
                line += (f"; camera mode (rays and pixels read in the kernels): records "
                         f"bit-equal and grids within tolerance of the same kernels on the plain "
                         f"camera_rays' rays {cam_ok}")
            worst["inverse_rec"] = max(worst["inverse_rec"], err_r)
            worst["inverse_global"] = max(worst["inverse_global"], err_g)
            if inverse_grid_fits(scene):
                ok5, err5 = grid_match(grid, grid_p)
                b5_b6, _ = grid_match(grid, reduced.float())
                ok = ok and ok5 and b5_b6 and torch.equal(st, st_p)
                worst["inverse_grid"] = max(worst["inverse_grid"], err5)
                line += (f"; B5 grid max |d| {err5:.3e} of max {float(grid_p.abs().max()):.3e}, "
                         f"visit counts equal {torch.equal(grid[..., 8], grid_p[..., 8])}, "
                         f"B5 = B6 reduced (rtol 1e-4) {b5_b6}, counts equal "
                         f"{torch.equal(st, st_p)}; B5's float32 grid against the records "
                         f"reduced needs rtol {grid64_gap(grid, reduced):.1e}")
            log(line + f" -> {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"an inverse kernel disagrees with its plain version on "
                                     f"{name}")
    return worst


def extraction_main_path(device):
    """Phase 12: the reference dataset configuration.  Scene 0 at 500x500,
    100 spp, 16 bounces, fused RNG: the target render, extract_graph through
    B5 (launch count, 1 warm-up and 3 runs timed, rays/s), the gates against
    artifacts/exp100 (data.npz[0], gcn0_params.npz), and a profile.
    Returns (launches, the graph, the target)."""
    import numpy as np
    import torch

    from inverse_path_tracer_torch import (
        GCN,
        RenderConfig,
        build_dense_graph,
        extract_graph,
        render_image,
        trace_transport_range,
    )
    from inverse_path_tracer_torch.convert import gcn_params_from_numpy, read_jax_checkpoint
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import inverse_tile

    cfg = RenderConfig(**GOLDEN)
    scene, mats = fixture(device)
    target = render_image(mats, scene, 1, cfg, device=device)

    def run(key):
        return extract_graph(scene, target, key, cfg, device=device)

    inverse_tile.launches = 0
    w, pixel, light = run(0)
    torch.cuda.synchronize()
    launches = inverse_tile.launches
    if launches == 0:
        raise AssertionError("the extraction did not launch inverse_grid")
    # The same trace again, for its ray counts.
    _, stats = trace_transport_range(scene, target, 0, cfg, 0, cfg.n_samples, device=device)
    rays = int(stats.segments) + int(stats.shadow_rays)
    log(f"extraction {shape(cfg)}: {launches} launches of inverse_grid, segments "
        f"{int(stats.segments)}, shadow rays {int(stats.shadow_rays)}")
    run(1)  # warm-up
    for k in range(3):
        t = cuda_ms(lambda: run(0), 1)
        log(f"extraction run {k}: {t:.3f} ms, rays {rays}, {rays / (t / 1e3):.6e} rays/s")
    profile_once("one extraction", lambda: run(0), ops=CAMERA_OPS)

    with np.load(os.path.join(EXP100, "data.npz")) as d:
        ref_w, ref_pix, labels = d["w"][0], d["pixel"][0], d["labels"][0]
    w_c, pix_c = w.cpu().numpy(), pixel.cpu().numpy()
    finite = all(bool(torch.isfinite(t).all()) for t in (w, pixel, light))
    sums = w_c.sum(axis=1)
    rows_ok = bool(np.all(np.abs(sums[sums > 0] - 1.0) <= 1e-5))
    eye = np.nonzero(w_c[-1])[0].tolist()
    pix_err = float(np.abs(pix_c[-1, EYE_VISIBLE] - ref_pix[-1, EYE_VISIBLE]).max())
    params, _ = read_jax_checkpoint(os.path.join(EXP100, "gcn0_params.npz"))
    model = GCN().to(device)
    model.load_state_dict(gcn_params_from_numpy(params, device=device))
    adj, feats = build_dense_graph(w, pixel)
    with torch.no_grad():
        pred = model(adj, feats).cpu().numpy()
    kd_err = float(np.abs(pred - labels).mean())
    ok = finite and rows_ok and eye == EYE_VISIBLE and pix_err <= 0.03 and kd_err < 0.05
    log(f"extraction gates: finite {finite}, visited rows sum to 1 (1e-5) {rows_ok}, eye row "
        f"nonzero on {eye}, eye-row pixel max |d| against data.npz[0] {pix_err:.5f} (bound 0.03)"
        f"; gcn0 Kd mean |error| {kd_err:.5f} (bound 0.05; JAX graphs of the fixture "
        f"0.030-0.035, data.npz[0] 0.00049) -> {'OK' if ok else 'FAIL'}")
    dw = np.abs(w_c - ref_w)
    log(f"extraction w against data.npz[0]: max |d| {float(dw.max()):.5f}, mean |d| "
        f"{float(dw.mean()):.6f}")
    if not ok:
        raise AssertionError("the extraction missed its gates")
    return launches, (w, pixel, light), target


def global_extraction(device, label, scene, target):
    """The extraction of `scene` at 500x500/100 spp/16 bounces through B6's
    global-grid sink (phases 13 and 20): launch counts (no inverse_tile_rec
    on the path), no NaN, visited rows summing to 1, one warm-up and 3 timed
    runs, and a profile that finds no aten::nonzero and gives B6's share of
    the device time.  Returns ({kernel: launches}: inverse_global's, and
    inverse_rec's, which the path does not run; rays; ms of the timed
    runs)."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, compress_grids, trace_transport_range
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        inverse_tile,
        inverse_tile_global,
        inverse_tile_rec,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import intersect_tile

    cfg = RenderConfig(**GOLDEN)

    def run():
        return trace_transport_range(scene, target, 0, cfg, 0, cfg.n_samples, device=device)

    counters = (inverse_tile, inverse_tile_rec, inverse_tile_global, intersect_tile)
    for c in counters:
        c.launches = 0
    grids, stats = run()
    w, pixel, light = compress_grids(grids, scene.n_tri)
    torch.cuda.synchronize()
    b5, rec, glob, sweep = (c.launches for c in counters)
    finite = all(bool(torch.isfinite(x).all()) for x in (w, pixel, light))
    sums = w.sum(dim=1)
    rows_ok = bool(((sums[sums > 0] - 1.0).abs() <= 1e-5).all())
    visited = int((sums > 0).sum())
    rays = int(stats.segments) + int(stats.shadow_rays)
    ok = glob > 0 and b5 == 0 and rec == 0 and finite and rows_ok and visited > scene.n_tri // 2
    log(f"{label} extraction {shape(cfg)}: {glob} launches of inverse_global ({rec} of "
        f"inverse_rec, {b5} of inverse_grid, {sweep} of the clustered sweep); rays {rays}; finite "
        f"{finite}, visited rows {visited} sum to 1 {rows_ok} -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the extraction failed")
    run()  # warm-up
    times = []
    for k in range(3):
        t = cuda_ms(run, 1)
        times.append(t)
        log(f"{label} extraction run {k}: {t:.3f} ms, rays {rays}, {rays / (t / 1e3):.6e} rays/s")
    kernels, calls = profile_once(f"one {label} extraction", run,
                                  ops=CAMERA_OPS + ("aten::nonzero",))
    if calls["aten::nonzero"]:
        raise AssertionError(f"the {label} extraction ran aten::nonzero")
    if kernels:
        busy = sum(ms for ms, _ in kernels.values())
        b6 = sum(ms for name, (ms, _) in kernels.items() if "inverse_global_kernel" in name)
        log(f"{label} extraction profile: B6 (global sink) {b6:.3f} ms ({100 * b6 / busy:.1f}% of "
            f"device time), the rest {busy - b6:.3f} ms")
    return {"inverse_global": glob, "inverse_rec": rec}, rays, times


def large_scene_extraction(device):
    """Phase 13: the 242-triangle vertex-normal scene at 500x500/100 spp/16
    bounces through B6's global-grid sink (global_extraction).  No main path
    runs B6's records sink: its launch count is this path's, 0, and phase 15
    holds it against its plain version.  Returns ({kernel: launches},
    (scene, target))."""
    from inverse_path_tracer_torch import RenderConfig, render_image

    cfg = RenderConfig(**GOLDEN)
    (_, scene, mats), = [v for v in variant_scenes(device) if v[0] == "vertex_normals"]
    target = render_image(mats, scene, 1, cfg, device=device)
    launches, _, _ = global_extraction(
        device, f"vertex-normal scene ({scene.n_tri} triangles)", scene, target)
    return launches, (scene, target)


def gcn_pipeline(device, graph, target):
    """Phase 14: train_gcn from a fresh init on the port's scene-0 graph
    (2000 Adam steps, lr 1e-4; last L1 < first), then render_with_materials
    with gcn0's prediction at 500x500/100 spp and its PSNR against the
    target."""
    import numpy as np
    import torch

    from inverse_path_tracer_torch import (
        GCN,
        RenderConfig,
        build_dense_graph,
        render_with_materials,
        train_gcn,
    )
    from inverse_path_tracer_torch.convert import gcn_params_from_numpy, read_jax_checkpoint
    from inverse_path_tracer_torch.models.gcn import gcn_loss
    from inverse_path_tracer_torch.utils.metrics import psnr

    w, pixel, _ = graph
    adj, feats = build_dense_graph(w, pixel)
    with np.load(os.path.join(EXP100, "data.npz")) as d:
        labels = torch.from_numpy(np.array(d["labels"][0])).to(device)
    with torch.no_grad():
        first = float(gcn_loss(GCN(seed=0).to(device), adj, feats, labels))
    steps = 2000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, last = train_gcn(adj, feats, labels, epochs=steps, lr=1e-4, seed=0, device=device)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / steps
    ok = last < first
    log(f"train_gcn on the port's scene-0 graph: {steps} Adam steps lr 1e-4, L1 {first:.5f} -> "
        f"{last:.5f}, {ms_step:.4f} ms per step -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train_gcn did not lower the loss")

    params, _ = read_jax_checkpoint(os.path.join(EXP100, "gcn0_params.npz"))
    gcn0 = GCN().to(device)
    gcn0.load_state_dict(gcn_params_from_numpy(params, device=device))
    with torch.no_grad():
        pred = gcn0(adj, feats)
    cfg = RenderConfig(**GOLDEN)
    os.makedirs(OUT_DIR, exist_ok=True)
    out_png = os.path.join(OUT_DIR, "rerender_gcn0.png")
    t0 = time.perf_counter()
    img8 = render_with_materials(os.path.join(REPO, "scenes", "0.txt"), out_png, pred, cfg,
                                 key=2, device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    value = psnr(img8.numpy().astype(np.float32) / 255.0, target.cpu().numpy())
    log(f"render_with_materials (gcn0's Kd) {shape(cfg)}: {dt:.3f} s, PSNR against the target "
        f"{value:.3f} dB ({out_png})")
    if not math.isfinite(value):
        raise AssertionError("the re-render's PSNR is not finite")
    return ms_step, value


def golden(device):
    """Phase 5: full-resolution golden gate."""
    import numpy as np
    import torch

    from inverse_path_tracer_torch import REFERENCE_CUBE_KD, RenderConfig, render_to_png
    from inverse_path_tracer_torch.utils.png import read_png

    cfg = RenderConfig(**GOLDEN)
    scene, mats = fixture(device, cube_kd=REFERENCE_CUBE_KD)
    os.makedirs(OUT_DIR, exist_ok=True)
    out_png = os.path.join(OUT_DIR, "golden_0.png")
    t0 = time.perf_counter()
    img8 = render_to_png(mats, scene, 1, cfg, out_png, device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ref = read_png(GOLDEN_PNG).astype(np.float32)
    d = np.abs(ref - img8.numpy().astype(np.float32))
    mean, p99 = float(d.mean()), float(np.percentile(d, 99))
    ok = mean < 5.0 and p99 < 25.0
    log(f"golden 500x500/100spp: {dt:.3f} s, mean |d| {mean:.4f}/255, p99 {p99:.2f}/255 "
        f"-> {'OK' if ok else 'FAIL'} ({out_png})")
    if not ok:
        raise AssertionError(f"golden mismatch: mean {mean:.4f} p99 {p99:.2f}")
    return mean, p99


def bound(t_ops, t_bytes):
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def reverse_sector_bytes(rec, k: int, flag_group: int):
    """Bytes of the 32-byte sectors (8 neighbouring lanes each) that a
    reverse kernel's loads fetch from records (k * 16, n): the hit and esc
    rows of the slots whose flags a lane reads, `flag_group` slots at a time
    up to the group that holds its first unreached slot, cut at k (B4,
    render_bwd.cu reached_slots: 1; B9's preloaded stages: k), and the 14
    record rows of every reached slot; a sector is fetched where any of its
    lanes loads it.  The function's own bound counts the reached records
    alone."""
    import torch

    r = rec.view(k, 16, -1)
    reached = (r[:, 14] != 0) | (r[:, 15] != 0)
    n_reached = reached.int().cumprod(dim=0).sum(dim=0)
    n = n_reached.numel()
    per_sector = torch.nn.functional.pad(n_reached, (0, -n % 8)).view(-1, 8).amax(dim=1)
    flag_slots = torch.clamp((per_sector // flag_group + 1) * flag_group, max=k)
    sectors = 14 * int(per_sector.sum()) + 2 * int(flag_slots.sum())
    return sectors * 32


def kernel_timing(device, launches, check_err):
    """Phase 10: every kernel at the main path's launch shape (the first
    cfg.tile_size samples of the bench render, fused RNG) against its plain
    version, its time beside the plain version's and its bound.  `launches`
    and `check_err` come from the earlier phases."""
    import torch

    from inverse_path_tracer_torch import RenderConfig
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        grad_tile,
        grad_tile_plain,
        render_tile,
        render_tile_plain,
        render_tile_rec,
        render_tile_rec_plain,
        reverse_tile,
        reverse_tile_plain,
    )

    cfg = RenderConfig(**MAIN)
    scene, mats = fixture(device)
    n = min(cfg.tile_size, cfg.n_samples)
    # The main path's inputs: the kernels make the primary rays (camera
    # mode); the plain versions make them with camera_rays.
    a = camera_launch(n, 0)
    rays = tile_inputs(scene, cfg, 0, n, device, external=False)
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(5)).to(device)
    nt = scene.n_tri
    rk, sk = render_tile(mats, scene, cfg, **a)
    rp, sp = render_tile_plain(mats, scene, cfg, **a)
    rq, sq = render_tile(mats, scene, cfg, **rays)  # B1 fed the plain camera_rays' rays
    rr, sr, rec = render_tile_rec(mats, scene, cfg, **a)
    _, _, rec_p = render_tile_rec_plain(mats, scene, cfg, **a)
    dk = grad_tile(mats, scene, cfg, g=g, **a)
    dp = grad_tile_plain(mats, scene, cfg, g=g, **a)
    d4 = reverse_tile(nt, cfg, rec, g)
    d4p = reverse_tile_plain(nt, cfg, rec, g)
    dk2 = grad_tile(mats, scene, cfg, g=g, **a)  # B2 again: the same sums in the same order
    b4_repeat = torch.equal(reverse_tile(nt, cfg, rec, g), d4)  # B4 again
    torch.cuda.synchronize()
    camera_same = torch.equal(rk, rq) and torch.equal(sk, sq)
    del rq, sq, rays
    err = {"render_fwd": float((rk - rp).abs().max()),
           "render_fwd_rec": float((rec - rec_p).abs().max()),
           "render_bwd_grad": float((dk - dp).abs().max()),
           "render_bwd_reverse": float((d4 - d4p).abs().max())}
    # B3's whole record array, the zeros past each ray's last bounce
    # included: slots at or past a lane's segment count are exactly 0 in the
    # kernel's and the plain version's arrays.
    past = torch.arange(cfg.max_bounces, device=device)[:, None] >= sk[0].long()[None, :]
    slot_max = lambda r: r.view(cfg.max_bounces, 16, n).abs().amax(dim=1)
    zeros_ok = not bool(slot_max(rec)[past].any()) and not bool(slot_max(rec_p)[past].any())
    b2_repeat = torch.equal(dk2, dk)
    ok = (torch.allclose(rk, rp, rtol=1e-4, atol=1e-5) and torch.equal(sk, sp)
          and torch.equal(rr, rk) and torch.equal(sr, sk) and camera_same
          and torch.allclose(rec, rec_p, rtol=1e-4, atol=1e-5) and zeros_ok
          and grad_close(dk, dp) and grad_close(d4, d4p) and b2_repeat and b4_repeat)
    log(f"full shape (3, {n}), rays made in the kernels: max |kernel - plain| " +
        ", ".join(f"{k} {e:.3e}" for k, e in err.items()) +
        f"; B1 bit-equal to B1 fed the plain camera_rays' rays {camera_same}; B3 radiance and "
        f"counts = B1 {torch.equal(rr, rk) and torch.equal(sr, sk)}, B3 "
        f"records within rtol 1e-4 / atol 1e-5 of plain over the whole array, "
        f"{int(past.sum())} unreached slots exactly 0 {zeros_ok}; B2 twice bit-equal "
        f"{b2_repeat}; B4 twice bit-equal {b4_repeat}; persistent grids: B1 "
        f"{render_tile.blocks}, B2 {grad_tile.blocks}, B3 {render_tile_rec.blocks} blocks of "
        f"256 -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version at full shape")
    del rec_p, past
    timed = {
        "render_fwd": (lambda: render_tile(mats, scene, cfg, **a),
                       lambda: render_tile_plain(mats, scene, cfg, **a)),
        "render_fwd_rec": (lambda: render_tile_rec(mats, scene, cfg, **a),
                           lambda: render_tile_rec_plain(mats, scene, cfg, **a)),
        "render_bwd_grad": (lambda: grad_tile(mats, scene, cfg, g=g, **a),
                            lambda: grad_tile_plain(mats, scene, cfg, g=g, **a)),
        "render_bwd_reverse": (lambda: reverse_tile(nt, cfg, rec, g),
                               lambda: reverse_tile_plain(nt, cfg, rec, g)),
    }
    ms = {k: cuda_ms(fn, 10) for k, (fn, _) in timed.items()}
    plain_ms = {k: cuda_ms(fn, 2) for k, (_, fn) in timed.items()}

    # Bounds, from this launch's rays.  Operations: the closest-hit sweeps the
    # rays needed, over the f32 peak.  A path of k segments needs its primary
    # sweep and the k - 1 sweeps of the rays that continued it (one per
    # segment), and a shadow sweep per segment that hit, which on a scene
    # with emitters is the shadow-ray count: segments + shadow rays sweeps.
    # Each (ray,
    # triangle) pair needs the face-plane test; the edge-plane tests run only
    # for candidates, which the run does not count, so they are left out and
    # the bound is a floor (the full four-plane test on every pair is printed
    # beside it).  The recursion adds RECURSION_OPS per reached bounce
    # (segment).  Bytes: each input read once, each output written once: the
    # kernels make the rays (no ray input), radiance and stats out (B1); plus
    # the whole record array out (B3); g in (B2); for B4 the records of the
    # reached bounces, one flag pair (hit, esc) where a ray stopped before
    # max_bounces, and g.  d materials out is nT*3 floats.
    if scene.n_emissive == 0:
        raise AssertionError("the bound counts hit segments by shadow rays")
    segments, shadows = float(sk[0].sum()), float(sk[1].sum())
    stopped_early = float((sk[0] < cfg.max_bounces).sum())
    pairs = (segments + shadows) * nt
    f_ops = lambda ops: ops / PEAK_F32_OPS * 1e3
    f_bytes = lambda nbytes: nbytes / PEAK_BYTES * 1e3
    t_sweep = f_ops(pairs * FACE_PLANE_OPS)
    t_full = f_ops(pairs * (FACE_PLANE_OPS + 3 * EDGE_PLANE_OPS))
    t_rec = f_ops(segments * RECURSION_OPS)
    rec_bytes = rec.numel() * 4
    out_bytes = nt * 3 * 4
    bounds = {
        "render_fwd": bound(t_sweep, f_bytes(n * (3 + 2) * 4)),
        "render_fwd_rec": bound(t_sweep, f_bytes(n * (3 + 2) * 4 + rec_bytes)),
        "render_bwd_grad": bound(t_sweep + t_rec, f_bytes(n * 3 * 4 + out_bytes)),
        "render_bwd_reverse": bound(t_rec, f_bytes(segments * 16 * 4 + stopped_early * 2 * 4
                                                   + n * 3 * 4 + out_bytes)),
    }
    b4_sectors = reverse_sector_bytes(rec, cfg.max_bounces, 1)
    log(f"B4's loads fetch {b4_sectors} bytes in 32-byte sectors ({f_bytes(b4_sectors):.4f} ms "
        f"at {PEAK_BYTES:.3g} B/s), against {segments * 64:.0f} bytes of reached records")
    log(f"launch (3, {n}): {segments:.0f} segments, {shadows:.0f} shadow rays, {pairs:.0f} "
        f"(ray, triangle) pairs, {stopped_early:.0f} rays stopped before {cfg.max_bounces} "
        f"bounces; sweep floor {t_sweep:.4f} ms (full four-plane test on every pair "
        f"{t_full:.4f} ms), recursion {t_rec:.4f} ms, record array {rec_bytes} bytes "
        f"({f_bytes(rec_bytes):.4f} ms to move once)")
    kernels = []
    for k, (b_ms, b_by) in bounds.items():
        src, replaces = KERNELS[k]
        log(f"{k} at (3, {n}): {ms[k]:.4f} ms (plain {plain_ms[k]:.3f} ms), bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / ms[k]:.1f}% of bound, {launches[k]} launches on its path")
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": f"inverse_path_tracer_torch/ops/kernels/{src}",
            "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": max(err[k], check_err[k]),
            "ms": ms[k],
            "plain_ms": plain_ms[k],
            "bound_ms": b_ms,
            "bound_by": b_by,
            # No single PyTorch call computes a bounce loop or its suffix
            # recursion.
            "library_ms": None,
        })
    return kernels


def first_extraction_launch(scene, cfg, target, key=0):
    """The kernel inputs of the first launch of trace_transport_range on
    `scene` (fused RNG, the camera under rng.CAMERA_STREAM), as the
    extraction passes them: the camera-mode inputs, the target image as the
    pixel input ({"image": (W*H, 3)}), and beside them the pixel colour of
    each lane (3, n), which the records' reduction takes, and the packed
    tables."""
    import torch

    from inverse_path_tracer_torch.ops import rng
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
    from inverse_path_tracer_torch.render.forward import _launches

    _, _, a = next(_launches(scene, cfg, key, 0, cfg.n_samples, None,
                             camera_key=rng.fold_in(key, rng.CAMERA_STREAM)))
    image = target.reshape(-1, 3).contiguous()
    c = a["camera"]
    idx = torch.arange(c.base, c.base + c.n, dtype=torch.int64, device=image.device)
    pix = image[(idx // cfg.spp).clamp(0, cfg.width * cfg.height - 1)].T.contiguous()
    return a, {"image": image}, pix, pack_tables(scene, scene.diffuse)


def inverse_kernel_timing(device, launches, check_err, target0, large):
    """Phase 15: B5 and B6, each at the first 2^20-ray launch of the path
    that runs it at 500x500/100 spp/16 bounces, fused RNG, the target's
    pixel colours: B5 on scene 0's extraction (phase 12), B6 with both sinks
    on the vertex-normal scene's (phase 13, `large` = (scene, target)).  B5
    and the records sink are held against their plain versions, the global
    grid against the records reduced, on the same inputs; each is timed
    beside its plain version and its bound."""
    import torch

    from inverse_path_tracer_torch import RenderConfig
    from inverse_path_tracer_torch.ops.intersect import counting_sweeps
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        grids_from_edge_records,
        inverse_tile,
        inverse_tile_global,
        inverse_tile_plain,
        inverse_tile_rec,
        inverse_tile_rec_plain,
        unperm_grid,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables

    cfg = RenderConfig(**GOLDEN)
    scene0, _ = fixture(device)
    scene_vn, target_vn = large
    a0, px0, _, tab0 = first_extraction_launch(scene0, cfg, target0)
    a6, px6, pix6, _ = first_extraction_launch(scene_vn, cfg, target_vn)
    tab6 = pack_tables(scene_vn, scene_vn.diffuse, cfg)
    n = a0["camera"].n

    grid, st = inverse_tile(scene0, cfg, tables=tab0, **px0, **a0)
    grid_p, st_p = inverse_tile_plain(scene0, cfg, **px0, **a0)
    torch.cuda.synchronize()
    ok5, e5 = grid_match(grid, grid_p)
    ok5 = ok5 and torch.equal(st, st_p)
    err = {"inverse_grid": e5}
    log(f"inverse_grid at scene 0's first extraction launch (3, {n}): max |d| {e5:.3e} of max "
        f"{float(grid_p.abs().max()):.3e}, visit counts and ray counts equal -> "
        f"{'OK' if ok5 else 'FAIL'}")
    del grid_p
    rec, st6 = inverse_tile_rec(scene_vn, cfg, tables=tab6, **a6)
    with counting_sweeps() as c6:
        rec_p, st6_p = inverse_tile_rec_plain(scene_vn, cfg, **a6)
    torch.cuda.synchronize()
    rec_ok, err["inverse_rec"], rec_same = records_match(rec, rec_p)
    ok6 = rec_ok and torch.equal(st6, st6_p)
    log(f"inverse_rec at the vertex-normal scene's first extraction launch (3, {n}), "
        f"{cfg.max_bounces} bounces: records max |d| {err['inverse_rec']:.3e} (bit-equal under "
        f"masks {rec_same}), ray counts equal {torch.equal(st6, st6_p)} -> "
        f"{'OK' if ok6 else 'FAIL'}")
    del rec_p
    reduced = grids_from_edge_records(rec, pix6.T, scene_vn, cfg, tab6.perm)
    acc, st_g = inverse_tile_global(scene_vn, cfg, tables=tab6, **px6, **a6)
    torch.cuda.synchronize()
    glob = unperm_grid(acc, tab6.perm)
    okg, gap = grid64_match(glob, reduced)
    okg = okg and torch.equal(st_g, st6_p)
    err["inverse_global"] = float((glob - reduced).abs().max())
    edges = float(reduced[..., 8].sum())
    log(f"inverse_global at the same launch: grid max |d| {err['inverse_global']:.3e} of max "
        f"{float(reduced.abs().max()):.3e} against the records reduced (rtol needed {gap:.1e}, "
        f"bound {GRID64_RTOL:.0e}), visit counts and ray counts equal, {edges:.0f} edges -> "
        f"{'OK' if okg else 'FAIL'}")
    if not (ok5 and ok6 and okg):
        raise AssertionError("an inverse kernel disagrees with its plain version at full shape")
    del reduced
    timed = {
        "inverse_grid": (lambda: inverse_tile(scene0, cfg, tables=tab0, **px0, **a0),
                         lambda: inverse_tile_plain(scene0, cfg, **px0, **a0)),
        "inverse_rec": (lambda: inverse_tile_rec(scene_vn, cfg, tables=tab6, **a6),
                        lambda: inverse_tile_rec_plain(scene_vn, cfg, **a6)),
        "inverse_global": (lambda: inverse_tile_global(scene_vn, cfg, tables=tab6, acc=acc,
                                                       **px6, **a6),
                           lambda: inverse_tile_plain(scene_vn, cfg, kernel_order=True, **px6,
                                                      **a6)),
    }
    for fn, _ in timed.values():
        fn()  # warm-up
    ms = {k: cuda_ms(fn, 10) for k, (fn, _) in timed.items()}
    plain_ms = {k: cuda_ms(fn, 2) for k, (_, fn) in timed.items()}

    # Bounds, from each launch's own rays.  Operations: the closest-hit
    # sweeps the loop uses, one per segment (the primary ray, or the next ray
    # of a path that passed roulette) and one per shadow ray, at
    # FACE_PLANE_OPS per (ray, triangle), over the f32 peak (a floor, as in
    # kernel_timing); on clustered tables what the plain version's clustered
    # sweeps did, its pairs and its box tests at BOX_OPS (as in
    # large_kernel_timing).  Bytes: the kernels make the rays (no ray
    # input); the target image (B5 and the global sink) and the tables in,
    # the counts (2, n) out, and B5's grid, the records sink's whole record
    # array, or the global sink's float64 adds (9 per edge, before the warp
    # sums them) out.
    f_bytes = lambda nbytes: nbytes / PEAK_BYTES * 1e3
    kernels = []
    image_bytes = cfg.width * cfg.height * 3 * 4
    for k, scene, stats, tab, out_bytes, in_bytes in (
            ("inverse_grid", scene0, st, tab0, grid.numel() * 4, image_bytes),
            ("inverse_rec", scene_vn, st6, tab6, rec.numel() * 4, 0),
            ("inverse_global", scene_vn, st_g, tab6, edges * N_QUANT_BYTES, image_bytes)):
        nt = scene.n_tri
        segments, shadows = float(stats[0].sum()), float(stats[1].sum())
        pairs, boxes = (segments + shadows) * nt, 0
        if tab.cluster_k:
            pairs, boxes = c6["pairs"], c6["group_tests"] + c6["tests"]
        t_sweep = (pairs * FACE_PLANE_OPS + boxes * BOX_OPS) / PEAK_F32_OPS * 1e3
        tab_bytes = sum(t.numel() * 4 for t in (tab.planes, tab.table, tab.vtab, tab.etab, tab.cdf)
                        if t is not None)
        b_ms, b_by = bound(t_sweep, f_bytes(n * 2 * 4 + in_bytes + tab_bytes + out_bytes))
        log(f"{k} launch (3, {n}) on {nt} triangles (clusters {tab.cluster_k}): {segments:.0f} "
            f"segments, {shadows:.0f} shadow rays, {pairs:.0f} (ray, triangle) pairs, {boxes} box "
            f"tests, sweep floor {t_sweep:.4f} ms, output {out_bytes:.0f} bytes "
            f"({f_bytes(out_bytes):.4f} ms to move once)")
        src, replaces = KERNELS[k]
        log(f"{k} at (3, {n}): {ms[k]:.4f} ms (plain {plain_ms[k]:.3f} ms), bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / ms[k]:.1f}% of bound, {launches[k]} launches on its path")
        kernels.append({
            "name": k, "route": "cuda", "source": f"inverse_path_tracer_torch/ops/kernels/{src}",
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": max(err[k], check_err[k]), "ms": ms[k], "plain_ms": plain_ms[k],
            "bound_ms": b_ms, "bound_by": b_by,
            # No single PyTorch call runs the inverse bounce loop.
            "library_ms": None,
        })
    return kernels


STAGED = ("init_tile", "stage_tile", "stage_reverse_tile", "cluster_sweep")


def lanes_equal(got, want, vertex_normals):
    """(fraction of lanes whose columns agree, max |d|): bit for bit on a
    flat scene, within rtol 1e-4 / atol 1e-5 on a vertex-normal one."""
    import torch

    if vertex_normals:
        same = torch.isclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        same = got == want
    d = (got.double() - want.double()).abs()
    d = d[torch.isfinite(d)]
    return float(same.all(dim=0).float().mean()), float(d.max()) if d.numel() else 0.0


def box_rays(tabs, n, seed, device):
    """Rays from points inside the cluster boxes, with zero direction
    components of either sign and axis-aligned rays (B10's edge cases)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    cab = tabs.cab.cpu()
    c = torch.randint(0, cab.shape[0], (n,), generator=g)
    o = cab[c, 0:3] + torch.rand((n, 3), generator=g) * (cab[c, 3:6] - cab[c, 0:3])
    d = torch.randn((n, 3), generator=g)
    d[torch.rand((n, 3), generator=g) < 0.2] = 0.0
    axis = torch.randint(0, 3, (n // 8,), generator=g)
    d[: n // 8] = torch.eye(3)[axis] * torch.where(torch.rand((n // 8, 1), generator=g) < 0.5,
                                                    -1.0, 1.0)
    d[n // 8 : n // 4, 1] = -0.0
    d[d.abs().sum(dim=1) == 0] = torch.tensor([0.0, -1.0, 0.0])
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    return o.T.contiguous().to(device), d.T.contiguous().to(device)


def check_staged_vs_plain(device):
    """Phase 16: B7, B8, B9 and B10 against their plain versions on the
    large scene (flat: exact; vertex normals: at least 97% of lanes), and
    staged against mega on the card.  Returns the largest |kernel - plain|
    of each over the flat cases."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, large_scene, render_samples
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        intersect_tile,
        intersect_tile_plain,
        pack_tables,
    )
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        init_tile,
        init_tile_plain,
        stage_reverse_tile,
        stage_reverse_tile_plain,
        stage_tile,
        stage_tile_plain,
    )

    cfg = RenderConfig(**CHECK)
    k, n = cfg.stage_bounces, cfg.n_samples
    worst = dict.fromkeys(STAGED, 0.0)
    for vn in (False, True):
        scene = large_scene(device, vertex_normals=vn)
        mats = scene.diffuse
        tabs = pack_tables(scene, mats, cfg)
        need = 0.97 if vn else 1.0
        for external in (True, False):
            name = f"{'vertex_normals' if vn else 'flat'} {'external' if external else 'fused'}"
            a = tile_inputs(scene, cfg, 31, n, device, external)
            carry = init_tile(mats, scene, cfg, a["p"], a["d"], a["alive"], tables=tabs)
            frac, err = lanes_equal(carry, init_tile_plain(mats, scene, cfg, a["p"], a["d"],
                                                           a["alive"]), vn)
            res = {"init_tile": (frac, err)}
            g = torch.rand((3, n), generator=torch.Generator().manual_seed(8)).to(device)
            suf = torch.zeros((4, n), device=device)
            ok = frac >= need
            if not external:  # B7 in camera mode: the same carry, bit for bit, twice
                cam = camera_launch(n, 31)["camera"]
                same7 = all(torch.equal(init_tile(mats, scene, cfg, camera=cam, tables=tabs),
                                        carry) for _ in range(2))
                res["init_tile camera mode = rays, twice"] = (float(same7), 0.0)
                ok = ok and same7
            for s in range(cfg.max_bounces // k):
                u_s = (a["uniforms"][s * k * 8 : (s + 1) * k * 8].contiguous() if external
                       else None)
                st = (mats, scene, cfg, carry, a["orig"], s * k, k, u_s, a.get("keys"))
                out, rec = stage_tile(*st, with_rec=True, tables=tabs)
                out_p, rec_p = stage_tile_plain(*st, with_rec=True)
                no_rec_same = torch.equal(stage_tile(*st, tables=tabs), out)
                f_c, e_c = lanes_equal(out, out_p, vn)
                f_r, e_r = lanes_equal(rec, rec_p, vn)
                dm, suf_o = stage_reverse_tile(scene.n_tri, cfg, k, rec, g, suf)
                dm2, suf_o2 = stage_reverse_tile(scene.n_tri, cfg, k, rec, g, suf)
                dm_p, suf_p = stage_reverse_tile_plain(scene.n_tri, cfg, k, rec, g, suf)
                b9 = (vn_grad_close(dm, dm_p) if vn else grad_close(dm, dm_p)) and bool(
                    torch.allclose(suf_o, suf_p, rtol=1e-5, atol=1e-6)) and torch.equal(
                    dm, dm2) and torch.equal(suf_o, suf_o2)
                ok = ok and f_c >= need and f_r >= need and no_rec_same and b9
                res[f"stage_tile {s}"] = (min(f_c, f_r), max(e_c, e_r))
                res[f"stage_reverse_tile {s}"] = (float(b9), float((dm - dm_p).abs().max()))
                carry, suf = out, suf_o
            t, idx = intersect_tile(scene, cfg, a["p"], a["d"], tables=tabs)
            t_p, idx_p = intersect_tile_plain(scene, cfg, a["p"], a["d"])
            pb, db = box_rays(tabs, n, 17, device)
            tb, ib = intersect_tile(scene, cfg, pb, db, tables=tabs)
            tb_p, ib_p = intersect_tile_plain(scene, cfg, pb, db)
            hits = torch.stack([torch.cat([t, tb]), torch.cat([idx, ib]).float()])
            hits_p = torch.stack([torch.cat([t_p, tb_p]), torch.cat([idx_p, ib_p]).float()])
            res["cluster_sweep"] = lanes_equal(hits, hits_p, vn)
            ok = ok and res["cluster_sweep"][0] >= need and float(torch.isfinite(tb).float().mean()) > 0.3
            torch.cuda.synchronize()
            if not vn:
                for key, (_, e) in res.items():
                    kname = key.split(" ")[0]
                    worst[kname] = max(worst[kname], e)
            log(f"check staged {name}: B7 on {init_tile.blocks} persistent blocks, "
                f"B9 on {stage_reverse_tile.blocks} "
                f"(its entries: 1.0 where it is within tolerance of plain and bit-equal across "
                f"two calls)")
            log(f"check staged {name} {shape(cfg)} ({scene.n_tri} triangles, clusters of "
                f"{tabs.cluster_k}): " + ", ".join(f"{key} {f:.5f} lanes agree / max |d| {e:.3e}"
                                                    for key, (f, e) in res.items())
                + f" -> {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"a staged kernel disagrees with its plain version on {name}")

    # Staged against mega on the card, bit for bit with equal counts.
    from inverse_path_tracer_torch.render.forward import camera_rays

    scene0, mats0 = fixture(device)
    flat = large_scene(device, vertex_normals=False)
    for name, scene, mats, c, external in (
            ("flat large fused", flat, flat.diffuse, cfg, False),
            ("flat large external", flat, flat.diffuse, cfg.with_(rng="external"), True),
            ("scene 0 fused", scene0, mats0, cfg.with_(wavefront="staged"), False)):
        kw = dict(device=device)
        if external:
            idx = torch.arange(n, device=device)
            kw["rays"] = camera_rays(scene, c, 5, idx)
            kw["uniforms"] = torch.rand((c.max_bounces * 8, n),
                                        generator=torch.Generator().manual_seed(6)).to(device)
        sv, ss = render_samples(mats, scene, 5, c, **kw)
        mv, ms = render_samples(mats, scene, 5, c.with_(wavefront="mega"), **kw)
        same = torch.equal(sv, mv) and [int(x) for x in ss] == [int(x) for x in ms]
        log(f"staged = mega on the card, {name}: bit-equal {torch.equal(sv, mv)}, segments "
            f"{int(ss.segments)} vs {int(ms.segments)}, shadow rays {int(ss.shadow_rays)} vs "
            f"{int(ms.shadow_rays)} -> {'OK' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"staged differs from mega on {name}")
    return worst


def over_budget_scene(device):
    """The box plus a flat lat-long sphere of 3840 triangles (3858 in all),
    built from a file written under build/chip_smoke/: its clustered sweep
    tables (64-byte plane rows, 32-byte cluster and group boxes) exceed a
    block's opt-in shared memory."""
    from inverse_path_tracer_torch import ASSET_ROOT, build_scene
    from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
    from inverse_path_tracer_torch.scene.dsl import ObjectParams

    os.makedirs(OUT_DIR, exist_ok=True)
    sphere = os.path.join(OUT_DIR, "sphere_3840.obj")
    with open(sphere, "w") as f:
        f.write(sphere_obj_text(rings=16, segments=128, normals=False))
    box = ObjectParams(pos=(0, 0, 4), scl=(2, 2, 2),
                       obj_file="CornellBox/CornellBox-Empty-CO.obj",
                       mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    ball = ObjectParams(pos=(0, -1.5, 4), obj_file=sphere, mtl_file="*Kd 0.5 0.5 0.5*")
    return build_scene([box, ball], asset_root=ASSET_ROOT).to(device)


def check_l1_branch(device):
    """Phase 16, last case: on over_budget_scene, whose clustered kernels
    read their sweep tables through L1, B1, B7 and B8 (every stage, with
    records, per lane and with the live-lane count of the staged
    orchestration) against their plain versions, bit for bit."""
    import torch

    from inverse_path_tracer_torch import RenderConfig
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        pack_tables,
        render_tile,
        render_tile_plain,
    )
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        init_tile,
        init_tile_plain,
        stage_tile,
        stage_tile_plain,
    )

    cfg = RenderConfig(**CHECK)
    k, n = cfg.stage_bounces, cfg.n_samples
    scene = over_budget_scene(device)
    mats = scene.diffuse
    tabs = pack_tables(scene, mats, cfg)
    nbytes = tabs.planes.numel() * 4 + (tabs.cab.shape[0] + tabs.gab.shape[0]) * 32
    if nbytes <= SMEM_OPT_IN:
        raise AssertionError(f"the sweep tables ({nbytes} bytes) fit in shared memory")
    a = tile_inputs(scene, cfg, 51, n, device, external=False)
    rk, sk = render_tile(mats, scene, cfg, tables=tabs, **a)
    rp, sp = render_tile_plain(mats, scene, cfg, **a)
    checks = {"B1": torch.equal(rk, rp) and torch.equal(sk, sp)}
    carry = init_tile(mats, scene, cfg, a["p"], a["d"], a["alive"], tables=tabs)
    checks["B7"] = torch.equal(carry, init_tile_plain(mats, scene, cfg, a["p"], a["d"],
                                                      a["alive"]))
    for s in range(cfg.max_bounces // k):
        st = (mats, scene, cfg, carry, a["orig"], s * k, k, None, a["keys"])
        out, rec = stage_tile(*st, with_rec=True, tables=tabs)
        out_p, rec_p = stage_tile_plain(*st, with_rec=True)
        order = torch.sort((carry[17] <= 0).to(torch.int32), stable=True).indices
        live = (carry[17] > 0).sum(dtype=torch.int32).reshape(1)
        out_l, rec_l = stage_tile(mats, scene, cfg, carry[:, order].contiguous(),
                                  a["orig"][:, order].contiguous(), s * k, k, None, a["keys"],
                                  with_rec=True, tables=tabs, live=live)
        checks[f"B8 stage {s}"] = (torch.equal(out, out_p) and torch.equal(rec, rec_p)
                                   and torch.equal(out_l, out[:, order])
                                   and torch.equal(rec_l, rec[:, order]))
        carry = out
    torch.cuda.synchronize()
    ok = all(checks.values())
    log(f"check L1 branch: {scene.n_tri} triangles, clusters of {tabs.cluster_k}, sweep tables "
        f"{nbytes} bytes > {SMEM_OPT_IN} of a block's shared memory, {shape(cfg)}: "
        + ", ".join(f"{key} bit-equal {v}" for key, v in checks.items())
        + f" -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a clustered kernel disagrees with its plain version on the L1 branch")


def check_clustered_vs_dense(device):
    """Phase 17: B1-B4 and B6 (both sinks) with clustered tables on the
    flat large scene against the plain versions of the dense sweep in global
    order; B5 with clusters of 8 on scene 0.  Returns the largest |kernel -
    plain|."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, large_scene
    from inverse_path_tracer_torch.ops.kernels import clusters
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        grids_from_edge_records,
        inverse_tile,
        inverse_tile_global,
        inverse_tile_plain,
        inverse_tile_rec,
        inverse_tile_rec_plain,
        unperm_grid,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        grad_tile,
        grad_tile_plain,
        pack_tables,
        render_tile,
        render_tile_plain,
        render_tile_rec,
        render_tile_rec_plain,
        reverse_tile,
    )

    cfg = RenderConfig(**CHECK)
    scene = large_scene(device, vertex_normals=False)
    mats = scene.diffuse
    a = tile_inputs(scene, cfg, 41, cfg.n_samples, device, external=False)
    g = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(9)).to(device)
    pix = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(10)).to(device)
    tabs = pack_tables(scene, mats, cfg)
    perm = tabs.perm
    rk, sk = render_tile(mats, scene, cfg, tables=tabs, **a)
    _, _, rec = render_tile_rec(mats, scene, cfg, tables=tabs, **a)
    d2 = grad_tile(mats, scene, cfg, g=g, tables=tabs, **a)
    d4 = reverse_tile(scene.n_tri, cfg, rec, g, perm)
    rec6, st6 = inverse_tile_rec(scene, cfg, tables=tabs, **a)
    grid6 = grids_from_edge_records(rec6, pix.T, scene, cfg, perm).float()
    acc6, st6g = inverse_tile_global(scene, cfg, pix=pix, tables=tabs, **a)
    glob6 = unperm_grid(acc6, perm)
    min_tp = clusters.CLUSTER_MIN_TP
    try:
        clusters.CLUSTER_MIN_TP = 1 << 30  # the plain versions sweep densely
        rp, sp = render_tile_plain(mats, scene, cfg, **a)
        _, _, rec_p = render_tile_rec_plain(mats, scene, cfg, **a)
        dp = grad_tile_plain(mats, scene, cfg, g=g, **a)
        rec6_p, st6_p = inverse_tile_rec_plain(scene, cfg, **a)
        # The dense sweep's order is the global one: float64 in global order.
        grid6_p64, _ = inverse_tile_plain(scene, cfg, pix=pix, kernel_order=True, **a)
        scene0, _ = fixture(device)
        cfg8 = cfg.with_(cluster_k=8)
        a0 = tile_inputs(scene0, cfg8, 42, cfg.n_samples, device, external=False)
        grid5_p, st5_p = inverse_tile_plain(scene0, cfg8, pix=pix, **a0)
        clusters.CLUSTER_MIN_TP = 8
        assert pack_tables(scene0, scene0.diffuse, cfg8).cluster_k == 8
        grid5, st5 = inverse_tile(scene0, cfg8, pix=pix, **a0)
    finally:
        clusters.CLUSTER_MIN_TP = min_tp
    torch.cuda.synchronize()
    # Records: every row equal once the internal triangle rows are mapped back.
    r, q = rec.view(cfg.max_bounces, 16, -1).clone(), rec_p.view(cfg.max_bounces, 16, -1)
    hit = r[:, 14] > 0
    r[:, 13][hit] = perm[r[:, 13][hit].long()].float()
    r6, q6 = rec6.view(cfg.max_bounces, 8, -1).clone(), rec6_p.view(cfg.max_bounces, 8, -1)
    to_g = torch.cat([perm, torch.tensor([scene.n_tri], device=device)])
    hit6 = r6[:, 2] > 0
    # dst of every reached slot (a miss keeps its weight), src and the
    # light's triangle where the slot hit.
    for row, mask in ((0, hit6 | (r6[:, 3] != 0)), (1, hit6), (6, hit6)):
        r6[:, row][mask] = to_g[r6[:, row][mask].long()].float()
    floor5 = 1e-6 * float(grid5_p.abs().max())
    grid6_p = grid6_p64.float()
    floor6 = 1e-6 * float(grid6_p.abs().max())
    checks = {
        "B1 radiance and counts equal": torch.equal(rk, rp) and torch.equal(sk, sp),
        "B3 records equal": torch.equal(r, q),
        "B2 within tolerance": grad_close(d2, dp),
        "B4 within tolerance": grad_close(d4, dp),
        "B6 records equal": torch.equal(r6, q6) and torch.equal(st6, st6_p),
        "B6 reduced grid": bool(torch.allclose(grid6, grid6_p, rtol=1e-4, atol=floor6)),
        "B6 global grid (float64 tolerance)": grid64_match(glob6, grid6_p64)[0]
        and torch.equal(st6g, st6_p),
        "B5 clusters of 8 on scene 0": bool(torch.allclose(grid5, grid5_p, rtol=1e-4,
                                                           atol=floor5))
        and torch.equal(grid5[..., 8], grid5_p[..., 8]) and torch.equal(st5, st5_p),
    }
    err = {"render_fwd": float((rk - rp).abs().max()),
           "render_fwd_rec": float((r - q).abs().max()),
           "render_bwd_grad": float((d2 - dp).abs().max()),
           "render_bwd_reverse": float((d4 - dp).abs().max()),
           "inverse_rec": float((r6 - q6).abs().max()),
           "inverse_global": float((glob6 - grid6_p64).abs().max()),
           "inverse_grid": float((grid5 - grid5_p).abs().max())}
    ok = all(checks.values())
    log(f"check clustered kernels (clusters of {tabs.cluster_k}, {scene.n_tri} triangles) against "
        f"dense plain {shape(cfg)}: " + ", ".join(f"{k} {v}" for k, v in checks.items())
        + "; max |d| " + ", ".join(f"{k} {e:.3e}" for k, e in err.items())
        + f" -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a clustered kernel disagrees with the dense plain version")
    return err


def large_main_path(device):
    """Phase 18: the large vertex-normal scene at 512x512/64 spp/16 bounces,
    staged: the forward (B7, B8, B10 launches), mega beside it, the forward
    at each cluster width of WIDTHS, fwd+bwd (B7, B8, B9) and
    loss_and_grad_range.
    Returns ({kernel: launches on its path}, the scene)."""
    import torch

    from inverse_path_tracer_torch import (
        RenderConfig,
        large_scene,
        loss_and_grad_range,
        render_samples,
    )
    from inverse_path_tracer_torch.ops.kernels import clusters
    from inverse_path_tracer_torch.ops.kernels.render_kernel import intersect_tile
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        init_tile,
        stage_reverse_tile,
        stage_tile,
    )
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    cfg = RenderConfig(**MAIN)
    scene = large_scene(device)
    mats = scene.diffuse
    label = f"large scene ({scene.n_tri} triangles, vertex normals) {shape(cfg)}"

    def timed_runs(what, fn, runs, stats_of):
        times = []
        for k in range(runs):
            out = []
            t = cuda_ms(lambda: out.append(fn(k + 2)), 1)
            st = stats_of(out[0])
            rays = int(st.segments) + int(st.shadow_rays)
            log(f"{what} run {k}: {t:.3f} ms, rays {rays}, {rays / (t / 1e3):.6e} rays/s")
            times.append(t)
        return times

    init_tile.launches = stage_tile.launches = intersect_tile.launches = 0
    vals, stats = render_samples(mats, scene, 0, cfg, device=device)
    torch.cuda.synchronize()
    launches = {"init_tile": init_tile.launches, "stage_tile": stage_tile.launches,
                "cluster_sweep": intersect_tile.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"the large-scene forward did not launch every kernel: {launches}")
    if vals.shape != (cfg.n_samples, 3) or not bool(torch.isfinite(vals).all()):
        raise AssertionError(f"bad radiance: shape {tuple(vals.shape)}")
    mean = float(vals.mean())
    if not 0.05 < mean < 50.0:
        raise AssertionError(f"implausible mean radiance {mean}")
    log(f"large main path {label}, staged: {launches['init_tile']} launches of init_tile, "
        f"{launches['stage_tile']} of stage_tile, {launches['cluster_sweep']} of the clustered "
        f"sweep; segments {int(stats.segments)}, shadow rays {int(stats.shadow_rays)}, mean "
        f"radiance {mean:.5f}")
    render = lambda key, c=cfg: render_samples(mats, scene, key, c, device=device)
    render(1)  # warm-up
    timed_runs("large forward staged", render, 3, lambda o: o[1])
    prof, _ = profile_once("one large staged render", lambda: render(7), ops=CAMERA_OPS)
    b8 = [(ms, count) for name, (ms, count) in prof.items() if "stage_kernel" in name]
    if b8:
        log(f"B8 over the large staged render: {sum(ms for ms, _ in b8):.3f} ms in "
            f"{sum(c for _, c in b8)} launches (profiler on)")
    mega = cfg.with_(wavefront="mega")
    timed_runs("large forward mega", lambda key: render(key, mega), 2, lambda o: o[1])
    best = {}
    for ck in WIDTHS:
        c = cfg.with_(cluster_k=ck)
        render(1, c)  # warm-up
        best[ck] = min(timed_runs(f"large forward staged cluster_k {ck}",
                                  lambda key: render(key, c), 2, lambda o: o[1]))
    auto = clusters.cluster_k_for(scene.n_tri, cfg)
    fastest = min(best, key=best.get)
    log(f"cluster widths, best of 2 runs each: " + ", ".join(f"{ck}: {t:.3f} ms"
                                                             for ck, t in best.items())
        + f"; fastest {fastest}, auto width {auto} (auto is the fastest: {auto == fastest})")

    def fwd_bwd(key):
        m = mats.clone().requires_grad_()
        v, st = render_samples(m, scene, key, cfg, device=device)
        tonemap_mean(v, cfg.spp).mean().backward()
        return m.grad, st

    init_tile.launches = stage_tile.launches = stage_reverse_tile.launches = 0
    grad, _ = fwd_bwd(0)
    torch.cuda.synchronize()
    fb = {"init_tile": init_tile.launches, "stage_tile": stage_tile.launches,
          "stage_reverse_tile": stage_reverse_tile.launches}
    if min(fb.values()) == 0:
        raise AssertionError(f"the large-scene fwd+bwd did not launch every kernel: {fb}")
    if not bool(torch.isfinite(grad).all()) or float(grad.abs().sum()) == 0.0:
        raise AssertionError("the large-scene gradient is not finite and nonzero")
    log(f"large fwd+bwd: {fb['init_tile']} launches of init_tile, {fb['stage_tile']} of "
        f"stage_tile, {fb['stage_reverse_tile']} of stage_reverse_tile; |grad|_1 "
        f"{float(grad.abs().sum()):.6e}, {int((grad != 0).any(dim=1).sum())} of {scene.n_tri} "
        f"triangles nonzero")
    fwd_bwd(1)  # warm-up
    timed_runs("large fwd+bwd", fwd_bwd, 2, lambda o: o[1])
    prof, _ = profile_once("one large fwd+bwd", lambda: fwd_bwd(7), ops=CAMERA_OPS)
    b9 = [(ms, count) for name, (ms, count) in prof.items() if "stage_reverse_kernel" in name]
    if b9:
        log(f"B9 over the large fwd+bwd: {sum(ms for ms, _ in b9):.3f} ms in "
            f"{sum(c for _, c in b9)} launches (profiler on)")

    n_values = cfg.width * cfg.height * 3

    def lg(key):
        return loss_and_grad_range(mats, scene, key, cfg, 0, cfg.n_samples,
                                   lambda v, lo: tonemap_mean(v, cfg.spp).sum() / n_values,
                                   device=device)

    init_tile.launches = stage_tile.launches = stage_reverse_tile.launches = 0
    loss, g_lg, _ = lg(0)
    torch.cuda.synchronize()
    lgl = (init_tile.launches, stage_tile.launches, stage_reverse_tile.launches)
    err = float(((g_lg - grad).abs() / grad.abs().clamp_min(1e-30)).max())
    ok = min(lgl) > 0 and bool(torch.allclose(g_lg, grad, rtol=1e-5, atol=0))
    log(f"large loss_and_grad_range: launches of init_tile, stage_tile, stage_reverse_tile {lgl}"
        f"; loss {float(loss):.7f}; max rel |grad - autograd's| {err:.3e} (bit-equal "
        f"{torch.equal(g_lg, grad)}) -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the staged loss_and_grad_range differs from autograd's gradient")
    timed_runs("large loss_and_grad_range", lg, 2, lambda o: o[2])
    launches["stage_reverse_tile"] = fb["stage_reverse_tile"]
    return launches, scene


def large_vn_extraction(device, scene):
    """Phase 20: the large vertex-normal scene at 500x500/100 spp/16
    bounces through clustered B6 with the global-grid sink
    (global_extraction).  Returns the target image it extracts against."""
    from inverse_path_tracer_torch import RenderConfig, render_image

    cfg = RenderConfig(**GOLDEN)
    target = render_image(scene.diffuse, scene, 1, cfg, device=device)
    global_extraction(device, f"large scene ({scene.n_tri} triangles)", scene,
                      target)
    return target


# The kernels whose last template argument is the search flavour
# (render_common.cuh Sweep; a bool kClustered in the kernels the BVH route
# does not run).
SWEEP_KERNELS = ("render_kernel", "intersect_kernel", "grad_tile_kernel", "stage_kernel",
                 "init_kernel", "inverse_rec_kernel", "inverse_global_kernel",
                 "inverse_grid_kernel")


def clustered_ptxas():
    """ptxas's report of the clustered kernels (the instantiations whose
    search flavour, their last template argument, is the clustered sweep:
    true or 1): [(library, kernel, registers, spill store bytes, spill load
    bytes)]."""
    from inverse_path_tracer_torch.ops.kernels import build

    def clustered(kernel):
        name, _, args = kernel.partition("<")
        return name in SWEEP_KERNELS and args.rstrip(">").split(", ")[-1] in ("true", "1")

    return [(lib, kernel, regs, st, ld)
            for lib, text in build.build_log.items()
            for kernel, regs, st, ld, _ in ptxas_report(text) if clustered(kernel)]


@contextlib.contextmanager
def captured_sweeps():
    """The rays of every clustered sweep that the plain versions run inside
    the block (render_kernel.py sweep calls ops/intersect.py
    intersect_clustered once a sweep step, on the lanes that sweep): yields
    the list of (origins, directions) (R, 3) of each call, in order."""
    from inverse_path_tracer_torch.ops.kernels import render_kernel

    calls, real = [], render_kernel.intersect_clustered

    def spy(planes, cab, gab, cluster_k, group, p, d, *args):
        calls.append((p, d))
        return real(planes, cab, gab, cluster_k, group, p, d, *args)

    render_kernel.intersect_clustered = spy
    try:
        yield calls
    finally:
        render_kernel.intersect_clustered = real


def kernel_sweep_work(scene, cfg, tabs, calls):
    """B10's work on the rays of `calls` (captured_sweeps), each call one
    launch of intersect_tile with `counts`, its warps 32 of the call's rays
    in a row: {group_tests, tests, pairs, slots} (render_common.cuh
    SweepWork)."""
    import torch

    from inverse_path_tracer_torch.ops.kernels.render_kernel import intersect_tile

    counts = torch.zeros(4, dtype=torch.int64, device=tabs.planes.device)
    for p, d in calls:
        if p.shape[0]:
            intersect_tile(scene, cfg, p.T.contiguous(), d.T.contiguous(), tables=tabs,
                           counts=counts)
    return dict(zip(("group_tests", "tests", "pairs", "slots"), counts.tolist()))


def sweep_work_line(what, c, k):
    """The sweep work of one launch of the plain version, the per-lane loop
    (counting_sweeps' dict c: the least work of the sweep), and of B10 on
    its rays (kernel_sweep_work's k): pairs, box tests, and the pair loop's
    lane-slots of the per-lane loop and of the kernel, with their SIMT
    efficiency (the pairs the sweep needs, the loop's, over the slots
    issued); raises where the kernel's group box tests differ from the
    loop's or its cluster box tests or pairs are fewer."""
    if k["group_tests"] != c["group_tests"] or k["tests"] < c["tests"] or k["pairs"] < c["pairs"]:
        raise AssertionError(f"{what}: B10's work {k} against the per-lane loop's {c}")
    return (f"{what}: {c['pairs']:.0f} (ray, triangle) pairs, B10 {k['pairs']} "
            f"({k['pairs'] / max(c['pairs'], 1):.4f}x), (ray, group) box tests "
            f"{c['group_tests']} of which {c['group_entered']} entered "
            f"({100 * c['group_entered'] / max(c['group_tests'], 1):.2f}%), (ray, cluster) box "
            f"tests {c['tests']} of which {c['entered']} entered "
            f"({100 * c['entered'] / max(c['tests'], 1):.2f}%), B10 {k['tests']}; pair "
            f"lane-slots: per-lane loop {c['loop_slots']} (efficiency "
            f"{c['pairs'] / max(c['loop_slots'], 1):.4f}), B10 {k['slots']} "
            f"({c['pairs'] / max(k['slots'], 1):.4f})")


def large_kernel_timing(device, launches, check_err, large_target):
    """Phase 21: B7, B8 (stages 0 to 3) and B9 at the first 2^20-ray launch
    of the large render (the vertex-normal scene, fused RNG), each against
    its plain version there (at least 97% of lanes agreeing) and timed
    beside its bound, B8 with the live-lane count as the staged
    orchestration passes it; B10 as B1 on that launch with clustered tables
    at the auto width and at JAX's 768 and with dense tables, with the box
    tests and the shares that entered; clustered B2 and B3 on that launch
    and clustered B6 (both sinks) on the first launch of the large
    extraction (phase 20, `large_target` its target), timed; the pair
    loop's lane-slots of a per-lane loop and of B10 on the rays of B7, of
    each B8 stage, of B1 and of B6 there (sweep_work_line); ptxas's
    registers and spills of the clustered kernels."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, large_scene
    from inverse_path_tracer_torch.ops.intersect import counting_sweeps
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        inverse_tile_global,
        inverse_tile_rec,
        inverse_tile_rec_plain,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        CAR_ALIVE,
        grad_tile,
        pack_tables,
        render_tile,
        render_tile_plain,
        render_tile_rec,
        reverse_tile,
    )
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        init_tile,
        init_tile_plain,
        stage_reverse_tile,
        stage_reverse_tile_plain,
        stage_tile,
        stage_tile_plain,
    )
    from inverse_path_tracer_torch.render.forward import _binned_order, _scene_bins

    cfg = RenderConfig(**MAIN)
    k = cfg.stage_bounces
    n_stages = -(-cfg.max_bounces // k)
    scene = large_scene(device)
    mats = scene.diffuse
    n = min(cfg.tile_size, cfg.n_samples)
    # The main path's inputs (camera mode) and, to hold B7 and B1 against,
    # the same launch fed the plain camera_rays' rays.
    a = camera_launch(n, 0)
    rays = tile_inputs(scene, cfg, 0, n, device, external=False)
    keys = a["keys"]
    tabs = pack_tables(scene, mats, cfg)
    jax_width = cfg.with_(cluster_k=768)
    tabs768 = pack_tables(scene, mats, jax_width)
    dense = pack_tables(scene, mats)
    bins = _scene_bins(scene, cfg)
    nt = scene.n_tri

    carry0 = init_tile(mats, scene, cfg, camera=a["camera"], tables=tabs)
    with counting_sweeps() as c_init, captured_sweeps() as rays_init:
        carry0_p = init_tile_plain(mats, scene, cfg, camera=a["camera"])
    work = {"B7": sweep_work_line("B7", c_init, kernel_sweep_work(scene, cfg, tabs, rays_init))}
    # B7 where the camera rays meet the sphere: the launch from sample 11 n,
    # 69% down the image (sample 16 * 2^20 of the 500x500/100 spp render).
    a_sph = camera_launch(n, 0, base=11 * n)
    with counting_sweeps() as c_init_sph, captured_sweeps() as rays_sph:
        init_tile_plain(mats, scene, cfg, camera=a_sph["camera"])
    work["B7 on the sphere"] = sweep_work_line(f"B7 from sample {11 * n}", c_init_sph,
                                               kernel_sweep_work(scene, cfg, tabs, rays_sph))
    del rays_sph
    del rays_init
    carry0_r = init_tile(mats, scene, cfg, rays["p"], rays["d"], rays["alive"], tables=tabs)
    carry0_2 = init_tile(mats, scene, cfg, camera=a["camera"], tables=tabs)
    b7_blocks = init_tile.blocks
    inputs, counts, agree = {}, {}, {"init_tile": lanes_equal(carry0, carry0_p, True),
                                     "B7 camera mode = rays": lanes_equal(carry0, carry0_r, False),
                                     "B7 twice": lanes_equal(carry0, carry0_2, False)}
    carry, orig = carry0, rays["orig"]
    del carry0_r, carry0_2
    for s in range(n_stages):
        order = _binned_order(carry, *bins, cfg.bin_cells)
        carry, orig = carry[:, order].contiguous(), orig[:, order].contiguous()
        live = (carry[CAR_ALIVE] > 0).sum(dtype=torch.int32).reshape(1)
        inputs[s] = (carry, orig, live)
        out = stage_tile(mats, scene, cfg, carry, orig, s * k, k, keys=keys, tables=tabs,
                         live=live)
        with counting_sweeps() as c, captured_sweeps() as rays_s:
            out_p = stage_tile_plain(mats, scene, cfg, carry, orig, s * k, k, keys=keys)
        counts[s] = dict(c)
        work[f"B8 stage {s}"] = sweep_work_line(f"B8 stage {s}", c,
                                                kernel_sweep_work(scene, cfg, tabs, rays_s))
        del rays_s
        agree[f"stage_tile {s}"] = lanes_equal(out, out_p, True)
        carry = out
    c0, o0, live0 = inputs[0]
    _, rec0 = stage_tile(mats, scene, cfg, c0, o0, 0, k, keys=keys, with_rec=True, tables=tabs,
                         live=live0)
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(5)).to(device)
    suf = torch.zeros((4, n), device=device)
    dm, suf_o = stage_reverse_tile(nt, cfg, k, rec0, g, suf)
    dm2, suf_o2 = stage_reverse_tile(nt, cfg, k, rec0, g, suf)
    dm_p, suf_p = stage_reverse_tile_plain(nt, cfg, k, rec0, g, suf)
    b9_same = torch.equal(dm, dm2) and torch.equal(suf_o, suf_o2)
    b9_ok = (grad_close(dm, dm_p) and bool(torch.allclose(suf_o, suf_p, rtol=1e-5, atol=1e-6))
             and b9_same)
    b9_blocks = stage_reverse_tile.blocks
    rb, sb = render_tile(mats, scene, cfg, tables=tabs, **a)
    rbr, sbr = render_tile(mats, scene, cfg, tables=tabs, **rays)
    rj, sj = render_tile(mats, scene, jax_width, tables=tabs768, **a)
    rd, sd = render_tile(mats, scene, cfg, tables=dense, **a)
    with counting_sweeps() as c_b1, captured_sweeps() as rays_b1:
        rp, sp = render_tile_plain(mats, scene, cfg, **a)
    work["B1 clustered"] = sweep_work_line("B1 clustered", c_b1,
                                           kernel_sweep_work(scene, cfg, tabs, rays_b1))
    del rays_b1
    with counting_sweeps() as c_768:
        render_tile_plain(mats, scene, jax_width, **a)
    torch.cuda.synchronize()
    agree["cluster_sweep (B1)"] = lanes_equal(rb, rp, True)
    agree["B1 camera mode = rays"] = lanes_equal(torch.cat([rb, sb]), torch.cat([rbr, sbr]),
                                                 False)
    agree["B1 at 768"] = lanes_equal(rj, rb, True)
    agree["dense B1"] = lanes_equal(rd, rb, True)
    ok = (all(f >= 0.97 for f, _ in agree.values()) and b9_ok
          and agree["B7 camera mode = rays"][0] == 1.0 and agree["B7 twice"][0] == 1.0)
    log(f"large launch (3, {n}), clusters of {tabs.cluster_k}: " + ", ".join(
        f"{key} {f:.5f} lanes agree (max |d| {e:.3e})" for key, (f, e) in agree.items())
        + f"; init_tile on {b7_blocks} persistent blocks"
        + f"; stage_reverse_tile on {b9_blocks} persistent blocks within tolerance and twice "
        f"bit-equal {b9_ok} (bit-equal {b9_same}, max |d| "
        f"{float((dm - dm_p).abs().max()):.3e}) -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a staged kernel disagrees with its plain version at full shape")

    def stage(s):
        c, o, lv = inputs[s]
        return lambda: stage_tile(mats, scene, cfg, c, o, s * k, k, keys=keys, tables=tabs,
                                  live=lv)

    def stage_plain(s):
        c, o, _ = inputs[s]
        return lambda: stage_tile_plain(mats, scene, cfg, c, o, s * k, k, keys=keys)

    timed = {
        "init_tile": (lambda: init_tile(mats, scene, cfg, camera=a["camera"], tables=tabs),
                      lambda: init_tile_plain(mats, scene, cfg, camera=a["camera"])),
        "init_tile from 11n": (
            lambda: init_tile(mats, scene, cfg, camera=a_sph["camera"], tables=tabs),
            lambda: init_tile_plain(mats, scene, cfg, camera=a_sph["camera"])),
        "stage_tile": (stage(0), stage_plain(0)),
        **{f"stage_tile {s}": (stage(s), stage_plain(s) if s == 2 else None)
           for s in range(1, n_stages)},
        "stage_reverse_tile": (lambda: stage_reverse_tile(nt, cfg, k, rec0, g, suf),
                               lambda: stage_reverse_tile_plain(nt, cfg, k, rec0, g, suf)),
        "cluster_sweep": (lambda: render_tile(mats, scene, cfg, tables=tabs, **a),
                          lambda: render_tile_plain(mats, scene, cfg, **a)),
        "cluster_sweep at 768": (lambda: render_tile(mats, scene, jax_width, tables=tabs768,
                                                     **a), None),
        "dense B1": (lambda: render_tile(mats, scene, cfg, tables=dense, **a), None),
    }
    for fn, _ in timed.values():
        fn()  # warm-up
    ms = {key: cuda_ms(fn, 5) for key, (fn, _) in timed.items()}
    plain_ms = {key: cuda_ms(fn, 1) for key, (_, fn) in timed.items() if fn is not None}

    # Bounds, from this launch's data.  Operations: what the clustered
    # sweeps of the plain version did, the per-lane loop's tests, the least
    # that the sweep needs (the hot cluster for every ray it sweeps, a group
    # or cluster box where the ray reached it, the clusters that the ray
    # enters before its closest hit so far): the (ray, triangle) pairs at FACE_PLANE_OPS each and the (ray,
    # box) tests at BOX_OPS each, over the f32 peak (a floor, as in phase
    # 10); the dense B1 sweeps every triangle.  B9: RECURSION_OPS per
    # reached slot.  Bytes: each input read once, each output written once:
    # the carry (24 floats) out for B7, which makes its rays; the carry in
    # and out and orig for B8; for B9 the reached records, a flag pair where
    # a lane stopped before the stage's last slot, g, the carry in and out
    # and d materials; radiance and counts out for B1.
    def f_ops(c):
        work = c["pairs"] * FACE_PLANE_OPS + (c["group_tests"] + c["tests"]) * BOX_OPS
        return work / PEAK_F32_OPS * 1e3

    f_bytes = lambda nbytes: nbytes / PEAK_BYTES * 1e3
    rr = rec0.view(k, 16, -1)
    reached = ((rr[:, 14] + rr[:, 15]) > 0)
    n_reached = float(reached.sum())
    stopped = float((reached.sum(dim=0) < k).sum())
    dense_pairs = float(sd.sum()) * nt  # a sweep per segment and per shadow ray
    ray_bytes = f_bytes(n * (3 + 2) * 4)
    bounds = {
        "init_tile": bound(f_ops(c_init), f_bytes(n * 24 * 4)),
        "init_tile from 11n": bound(f_ops(c_init_sph), f_bytes(n * 24 * 4)),
        "stage_tile": bound(f_ops(counts[0]), f_bytes(n * (48 + 1) * 4)),
        **{f"stage_tile {s}": bound(f_ops(counts[s]), f_bytes(n * (48 + 1) * 4))
           for s in range(1, n_stages)},
        "stage_reverse_tile": bound(n_reached * RECURSION_OPS / PEAK_F32_OPS * 1e3,
                                    f_bytes(n_reached * 16 * 4 + stopped * 2 * 4
                                            + n * (3 + 8) * 4 + nt * 3 * 4)),
        "cluster_sweep": bound(f_ops(c_b1), ray_bytes),
        "cluster_sweep at 768": bound(f_ops(c_768), ray_bytes),
        "dense B1": bound(dense_pairs * FACE_PLANE_OPS / PEAK_F32_OPS * 1e3, ray_bytes),
    }
    for line in work.values():
        log(f"large launch (3, {n}) sweep work, {line}")
    c = c_768
    log(f"large launch (3, {n}) sweep work, B1 at 768: {c['pairs']:.0f} (ray, triangle) pairs, "
        f"(ray, group) box tests {c['group_tests']} of which {c['group_entered']} entered, "
        f"(ray, cluster) box tests {c['tests']} of which {c['entered']} entered")
    b9_sectors = reverse_sector_bytes(rec0, k, k)
    log(f"large launch (3, {n}): dense sweeps {dense_pairs:.0f} pairs; B9 reached slots "
        f"{n_reached:.0f}, its loads fetch {b9_sectors} bytes in 32-byte sectors "
        f"({f_bytes(b9_sectors):.4f} ms at {PEAK_BYTES:.3g} B/s)")
    log(f"B10 as B1 on the large launch: clusters of {tabs.cluster_k} {ms['cluster_sweep']:.4f} "
        f"ms, of 768 {ms['cluster_sweep at 768']:.4f} ms, dense {ms['dense B1']:.4f} ms")
    b8_sum = sum(ms[key] for key in ms if key.startswith("stage_tile"))
    log(f"B8 at the large launch: stages 0-{n_stages - 1} "
        + ", ".join(f"{ms[key]:.4f}" for key in ms if key.startswith("stage_tile"))
        + f" ms, sum {b8_sum:.4f} ms, bound sum "
        f"{sum(bounds[key][0] for key in ms if key.startswith('stage_tile')):.4f} ms")

    # Clustered B2 and B3 on this launch, clustered B6 on the first launch of
    # the large extraction: times beside B10's.
    g3 = torch.rand((3, n), generator=torch.Generator().manual_seed(9)).to(device)
    golden_cfg = RenderConfig(**GOLDEN)
    a6, px6, _, _ = first_extraction_launch(scene, golden_cfg, large_target)
    tab6 = pack_tables(scene, mats, golden_cfg)
    with counting_sweeps() as c6, captured_sweeps() as rays6:
        inverse_tile_rec_plain(scene, golden_cfg, **a6)
    log(f"large extraction's first launch (3, {a6['camera'].n}) sweep work, "
        + sweep_work_line("B6", c6, kernel_sweep_work(scene, golden_cfg, tab6, rays6)))
    del rays6
    acc6 = torch.zeros((nt + 1, nt, 9), dtype=torch.float64, device=device)
    _, _, rec_b3 = render_tile_rec(mats, scene, cfg, tables=tabs, **a)
    b4_sectors = reverse_sector_bytes(rec_b3, cfg.max_bounces, 1)
    log(f"B4 on clustered B3's records of the large launch: its loads fetch {b4_sectors} bytes "
        f"in 32-byte sectors ({f_bytes(b4_sectors):.4f} ms at {PEAK_BYTES:.3g} B/s)")
    more = {
        "render_bwd_grad (B2) clustered": lambda: grad_tile(mats, scene, cfg, g=g3, tables=tabs,
                                                            **a),
        "render_bwd_reverse (B4) on clustered B3's records": lambda: reverse_tile(
            nt, cfg, rec_b3, g3),
        "render_fwd_rec (B3) clustered": lambda: render_tile_rec(mats, scene, cfg, tables=tabs,
                                                                 **a),
        "inverse_rec (B6 records) clustered, extraction launch": lambda: inverse_tile_rec(
            scene, golden_cfg, tables=tab6, **a6),
        "inverse_global (B6 global grid) clustered, extraction launch": lambda: (
            inverse_tile_global(scene, golden_cfg, tables=tab6, acc=acc6, **px6, **a6)),
    }
    for what, fn in more.items():
        fn()  # warm-up
        log(f"{what} at (3, {n}): {cuda_ms(fn, 3):.4f} ms (clusters of {tabs.cluster_k})")
    del rec_b3

    report = clustered_ptxas()
    for lib, kernel, regs, st, ld in report:
        log(f"  ptxas {lib} {kernel}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    b8_b1 = [(st, ld) for _, kernel, _, st, ld in report
             if kernel.startswith(("stage_kernel", "render_kernel<"))]
    if b8_b1:
        log(f"clustered B8 and B1 spill-free: {all(st == 0 and ld == 0 for st, ld in b8_b1)}")
    else:
        log("clustered B8 and B1 spills: not reported (render_fwd was built before this run)")

    kernels = []
    for key, (b_ms, b_by) in bounds.items():
        pm = plain_ms.get(key)
        log(f"{key} at the large launch (3, {n}): {ms[key]:.4f} ms"
            + (f" (plain {pm:.3f} ms)" if pm is not None else "")
            + f", bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms[key]:.2f}% of bound")
        if key not in STAGED:
            continue
        src, replaces = KERNELS[key]
        kernels.append({
            "name": key, "route": "cuda", "source": f"inverse_path_tracer_torch/ops/kernels/{src}",
            "replaces": replaces, "launches": launches[key], "max_abs_err": check_err[key],
            "ms": ms[key], "plain_ms": pm, "bound_ms": b_ms, "bound_by": b_by,
            # No single PyTorch call runs a stage of the bounce loop, its
            # recursion or a closest-hit sweep.
            "library_ms": None,
        })
    return kernels


def reorder_phase(device):
    """Phase 28: the staged wavefront's re-sort (reorder.cu, reorder_tile)
    at the first 2^20-lane launch of the large vertex-normal render (camera
    mode, fused RNG, as the main path runs it): at each of its 4 stages,
    binned and alive first, the kernel's order, carry, orig and live equal
    its plain version's (the parent's chain of PyTorch ops: the key, the
    stable sort, the gathers, the live count) bit for bit, with B8 between
    the stages on the kernel's outputs; each stage timed beside its byte
    bound and the plain chain.  Then one 500x500/100 spp render of the scene
    counts 96 reorder_tile launches (24 launches of 4 stages).  Returns the
    kernel's row."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, large_scene, render_samples
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
    from inverse_path_tracer_torch.ops.kernels.reorder_kernel import (
        ReorderScratch,
        reorder_tile,
        reorder_tile_plain,
    )
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import init_tile, stage_tile
    from inverse_path_tracer_torch.render.forward import _scene_bins

    t_phase = time.perf_counter()
    cfg = RenderConfig(**MAIN)
    k = cfg.stage_bounces
    n_stages = -(-cfg.max_bounces // k)
    scene = large_scene(device)
    mats = scene.diffuse
    n = min(cfg.tile_size, cfg.n_samples)
    a = camera_launch(n, 0)
    tabs = pack_tables(scene, mats, cfg)
    bins, cells = _scene_bins(scene, cfg), cfg.bin_cells
    carry = init_tile(mats, scene, cfg, camera=a["camera"], tables=tabs)
    orig = torch.arange(n, dtype=torch.int32, device=device)[None]
    scratch = ReorderScratch()
    inputs, live = [], []
    for s in range(n_stages):
        inputs.append((carry, orig.clone()))
        for b in (None, bins):
            got = reorder_tile(carry, orig, b, cells, True, scratch=scratch)
            want = reorder_tile_plain(carry, orig, b, cells, True)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"reorder_tile ({'binned' if b else 'alive first'}) differs "
                                     f"from its plain version at stage {s}")
        carry, orig, lv, _ = got  # binned, as the main path
        live.append(int(lv))
        carry = stage_tile(mats, scene, cfg, carry, orig, s * k, k, keys=a["keys"], tables=tabs,
                           live=lv)
    bound_ms = n * 2 * (CARRY_ROWS_BYTES + 4) / PEAK_BYTES * 1e3  # carry and orig in and out
    ms, plain_ms = {}, {}
    timing = ReorderScratch()
    for s, (c, o) in enumerate(inputs):
        for label, b in (("binned", bins), ("alive first", None)):
            fn = lambda: reorder_tile(c, o, b, cells, False, scratch=timing)  # noqa: E731
            fn_p = lambda: reorder_tile_plain(c, o, b, cells, False)  # noqa: E731
            fn()  # warm-up
            fn_p()
            ms[s, label], plain_ms[s, label] = cuda_ms(fn, 20), cuda_ms(fn_p, 5)
    for s in range(n_stages):
        log(f"reorder_tile at the large launch (24, {n}), stage {s} ({live[s]} live lanes): "
            + ", ".join(f"{label} {ms[s, label]:.4f} ms (plain chain {plain_ms[s, label]:.4f} ms)"
                        for label in ("binned", "alive first"))
            + f", bound {bound_ms:.4f} ms (bytes), {100 * bound_ms / ms[s, 'binned']:.1f}% of it")
    golden = RenderConfig(**GOLDEN)
    expected = -(-golden.n_samples // golden.tile_size) * n_stages  # 24 x 4 = 96
    before = reorder_tile.launches
    render_samples(mats, scene, 0, golden, device=device)
    torch.cuda.synchronize()
    launches = reorder_tile.launches - before
    if launches != expected:
        raise AssertionError(f"a {shape(golden)} render ran {launches} reorder_tile launches, "
                             f"not {expected}")
    mean = lambda d: sum(v for (_, label), v in d.items() if label == "binned") / n_stages
    log(f"reorder_tile: bit-equal to the plain chain at all {n_stages} stages, binned and alive "
        f"first; {launches} launches a {shape(golden)} render; stages 0-{n_stages - 1} binned "
        f"mean {mean(ms):.4f} ms, plain chain {mean(plain_ms):.4f} ms "
        f"(phase 28: {time.perf_counter() - t_phase:.1f} s)")
    return {"name": "reorder_tile", "route": "cuda",
            "source": "inverse_path_tracer_torch/ops/kernels/reorder.cu",
            "replaces": "none: the JAX package sorts between stages with XLA "
                        "(inverse_path_tracer_tpu/render/forward.py:620, :635)",
            "launches": launches, "max_abs_err": 0.0, "ms": mean(ms), "plain_ms": mean(plain_ms),
            "bound_ms": bound_ms, "bound_by": "bytes",
            # The plain version is the chain of PyTorch calls it replaced;
            # no single call sorts and gathers.
            "library_ms": None}


def batch_scenes(n, device):
    """Scene 0's geometry and the (n, nT, 3) labels of scenes/0..n-1.txt,
    which must share scene 0's vertices (they differ in the cube's Kd)."""
    import torch

    from inverse_path_tracer_torch import ASSET_ROOT, load_scene

    scenes = [load_scene(os.path.join(REPO, "scenes", f"{i}.txt"), asset_root=ASSET_ROOT)
              for i in range(n)]
    for i, s in enumerate(scenes):
        if not torch.equal(s.vertices, scenes[0].vertices):
            raise AssertionError(f"scenes/{i}.txt does not share scene 0's vertices")
    return scenes[0].to(device), torch.stack([s.diffuse for s in scenes]).to(device)


def batched_recovery(device):
    """Phase 22: recover_materials_batched (B1 forward, B2 backward) at
    BASELINE config #4, scenes 0-15 at 256x256/64 spp/16 bounces, targets
    rendered with each scene's labels under keys distinct from the
    recovery's: 30 steps at lr 0.1 from theta = 0, gates of phase 9 (last
    loss < 0.75 x first, mean Kd error over the scenes < 0.7 x the
    start's), ms per step and rays/s; then 2 steps over all 100 scenes from
    artifacts/exp100/gcn_init_256.npy (scripts/run_recover100.py's
    configuration), timed, its sigmoid(theta) at step 0 within 1e-6 of the
    clipped init; then at 64x64/8 spp/8 bounces with 4 scenes: scene_chunk
    0, 1 and 3 bit-identical over 3 steps, a resume at step 4 of 8 with
    average_last 6 bit-identical to the uninterrupted run, and n_keys 2.
    Returns ms per step at 16 and at 100 scenes."""
    import numpy as np
    import torch

    from inverse_path_tracer_torch import (
        RenderConfig,
        recover_materials_batched,
        render_image,
        render_samples,
    )
    from inverse_path_tracer_torch.ops import rng
    from inverse_path_tracer_torch.ops.kernels.render_kernel import grad_tile, render_tile

    t_phase = time.perf_counter()
    target_key, key = 100, 1

    def targets_of(scene, labels, cfg):
        return torch.stack([render_image(labels[j], scene, rng.fold_in(target_key, j), cfg,
                                         device=device) for j in range(labels.shape[0])])

    def timed(scene, targets, cfg, steps, **kw):
        """(materials, losses, ms of each step: synchronized wall clock)."""
        stamps = []

        def stamp(_i, _loss):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mats, losses = recover_materials_batched(scene, targets, cfg, steps=steps, lr=0.1,
                                                 key=key, log_fn=stamp, device=device, **kw)
        return mats, losses, np.diff([t0] + stamps) * 1e3

    def step_rays(scene, mats, cfg, step):
        """Rays (segments + shadow rays) of every scene's forward under step
        `step`'s keys, rendered again at `mats`."""
        step_key = rng.fold_in(key, step)
        total = 0
        with torch.no_grad():
            for j in range(mats.shape[0]):
                _, st = render_samples(mats[j], scene, rng.fold_in(step_key, j), cfg,
                                       device=device)
                total += int(st.segments) + int(st.shadow_rays)
        return total

    cfg = RenderConfig(**BATCH)
    result = {}
    for n, steps, init in ((16, 30, None), (100, 2, os.path.join(EXP100, "gcn_init_256.npy"))):
        scene, labels = batch_scenes(n, device)
        targets = targets_of(scene, labels, cfg)
        kw = {}
        if init is not None:
            kw["init_materials"] = np.load(init)
            start, _ = recover_materials_batched(scene, targets, cfg, steps=0, device=device,
                                                 **kw)
            m0 = np.clip(kw["init_materials"], 1e-4, 1 - 1e-4)
            gap = float(np.abs(start.cpu().numpy() - m0).max())
            log(f"batched recovery, {n} scenes: sigmoid(theta) at step 0 against the clipped "
                f"init max |d| {gap:.3e} (bound 1e-6)")
            if not gap <= 1e-6:
                raise AssertionError("init_materials did not start theta at logit(init)")
        torch.cuda.reset_peak_memory_stats(device)
        render_tile.launches = grad_tile.launches = 0
        mats, losses, ms = timed(scene, targets, cfg, steps, **kw)
        launches = (render_tile.launches, grad_tile.launches)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        if not all(launches):
            raise AssertionError(f"batched recovery launched render_fwd/render_bwd_grad "
                                 f"{launches} times")
        rays = step_rays(scene, mats, cfg, steps - 1)
        med = float(np.median(ms))
        err0 = float((0.5 - labels).abs().mean()) if init is None else None
        err = float((mats - labels).abs().mean())
        finite = all(math.isfinite(v) for v in losses) and bool(torch.isfinite(mats).all())
        log(f"batched recovery {n} scenes {shape(cfg)}, {steps} steps lr 0.1"
            f"{' from gcn_init_256.npy' if init else ''}: {launches[0]} launches of render_fwd, "
            f"{launches[1]} of render_bwd_grad; loss {losses[0]:.5f} -> {losses[-1]:.5f}, Kd "
            f"error {err:.5f}; ms per step {', '.join(f'{t:.1f}' for t in ms)} (median "
            f"{med:.1f}); rays per step {rays} (a forward of step {steps - 1}'s keys at the "
            f"recovered Kd), {rays / (med / 1e3):.6e} rays/s; peak device memory {peak:.2f} GiB")
        if not finite:
            raise AssertionError("batched recovery gave non-finite losses or materials")
        if init is None:
            ok = losses[-1] < 0.75 * losses[0] and err < 0.7 * err0
            log(f"batched recovery gates: loss {losses[-1] / losses[0]:.3f}x (bound 0.75), Kd "
                f"error {err0:.5f} -> {err:.5f} ({err / err0:.3f}x, bound 0.7) -> "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("batched recovery missed its criteria")
        result[n] = med

    cfg = RenderConfig(**RECOVER)
    scene, labels = batch_scenes(4, device)
    targets = targets_of(scene, labels, cfg)
    run = lambda steps, **kw: recover_materials_batched(scene, targets, cfg, steps=steps, lr=0.1,
                                                        key=key, device=device, **kw)
    whole, whole_losses = run(3)
    for chunk in (1, 3):
        mats, losses = run(3, scene_chunk=chunk)
        same = torch.equal(mats, whole) and losses == whole_losses
        log(f"batched recovery 4 scenes {shape(cfg)}: scene_chunk {chunk} bit-equal to 0 over 3 "
            f"steps {same}")
        if not same:
            raise AssertionError(f"scene_chunk {chunk} changed the batched recovery")
    ckpt = os.path.join(OUT_DIR, "recover_batched.npz")
    for path in (ckpt, ckpt + ".avg"):
        if os.path.exists(path):
            os.remove(path)
    full, full_losses = run(8, average_last=6)
    run(4, average_last=2, checkpoint_path=ckpt, checkpoint_every=4)
    resumed, tail = run(8, average_last=6, checkpoint_path=ckpt, resume=True)
    same = torch.equal(resumed, full) and tail == full_losses[4:]
    log(f"batched recovery resume at step 4 of 8 inside the averaging window (average_last 6): "
        f"bit-equal to the uninterrupted run {same}")
    if not same:
        raise AssertionError("a resumed batched recovery differs from the uninterrupted one")
    mats, losses = run(2, n_keys=2)
    ok = all(math.isfinite(v) for v in losses) and bool(torch.isfinite(mats).all())
    log(f"batched recovery n_keys 2: losses {', '.join(f'{v:.5f}' for v in losses)} finite {ok}")
    if not ok:
        raise AssertionError("batched recovery with n_keys 2 is not finite")
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return result


def cli_commands(device):
    """Phase 23: the CLI on the card.  One subprocess, python3 -m
    inverse_path_tracer_torch.cli render --profile at 512x512/64 spp (the
    module entry point on a machine without JAX or PIL); then every command
    through cli.main in build/chip_smoke/cli, without --cpu, each timed
    (synchronized wall clock) with the kernel launches it made: generate 2
    (128x128/16 spp), render of both scenes at 500x500/100 spp,
    extract-graph of both (B5), train-gcn (500 epochs, last loss < first),
    evaluate with that checkpoint and with gcn0_params.npz (4 files in each
    zip), graph-viz (counts against artifacts/graphviz), render at 64x64/8
    spp, recover and recover-batch 2 (10 steps), make-dataset 2.  Returns
    {command: seconds}."""
    import shutil
    import zipfile

    import numpy as np
    import torch

    from inverse_path_tracer_torch import cli
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import inverse_tile
    from inverse_path_tracer_torch.ops.kernels.render_kernel import grad_tile, render_tile
    from inverse_path_tracer_torch.utils.plyviz import read_ply_counts
    from inverse_path_tracer_torch.utils.png import read_png

    t_phase = time.perf_counter()
    work = os.path.join(OUT_DIR, "cli")
    shutil.rmtree(work, ignore_errors=True)
    for sub in ("big", "small"):  # render writes into an existing directory
        os.makedirs(os.path.join(work, sub))
    at = lambda *p: os.path.join(work, *p)
    scene0 = os.path.join(REPO, "scenes", "0.txt")
    size = lambda w, spp, b=16: ["--width", str(w), "--height", str(w), "--spp", str(spp),
                                 "--bounces", str(b)]

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "inverse_path_tracer_torch.cli", "render", scene0, at("0.png"),
         "--profile", at("trace"), *size(512, 64)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    log(f"cli subprocess render 512x512/64spp/16b --profile: {dt:.3f} s, rc {proc.returncode}: "
        + " | ".join(proc.stdout.strip().splitlines()))
    if proc.returncode != 0:
        raise AssertionError(f"python3 -m inverse_path_tracer_torch.cli render failed:\n"
                             f"{proc.stderr[-4000:]}")
    traces = os.listdir(at("trace")) if os.path.isdir(at("trace")) else []
    if read_png(at("0.png")).shape != (512, 512, 3) or not traces:
        raise AssertionError(f"the subprocess render wrote no 512x512 PNG or no trace ({traces})")
    times = {"render (subprocess, --profile)": dt}

    counters = {"render_fwd": render_tile, "render_bwd_grad": grad_tile,
                "inverse_grid": inverse_tile}

    def run(label, argv, expect):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items() if c.launches}
        log(f"cli {label}: {dt:.3f} s, launches {got}")
        missing = [k for k in expect if not got.get(k)]
        if missing:
            raise AssertionError(f"cli {label} launched no {missing}")
        times[label] = dt

    run("generate 2", ["generate", "2", "--scenes-dir", at("scenes"), "--imgs-dir", at("imgs"),
                       *size(128, 16)], ["render_fwd"])
    for i in range(2):
        run(f"render scene {i}", ["render", at("scenes", f"{i}.txt"), at("big", f"{i}.png"),
                                  *size(500, 100)], ["render_fwd"])
    big = size(500, 100)
    for i in range(2):
        run(f"extract-graph scene {i}", ["extract-graph", at("scenes", f"{i}.txt"),
                                         at("big", f"{i}.png"), at(f"graph_{i}.npz"), *big],
            ["inverse_grid"])
    with np.load(at("graph_0.npz")) as g:
        w0 = np.array(g["w"])
    if w0.shape != (31, 30) or read_png(at("imgs", "1.png")).shape != (128, 128, 3):
        raise AssertionError(f"extract-graph wrote w {w0.shape}")
    run("train-gcn", ["train-gcn", at("graph_0.npz"), at("graph_1.npz"), "--out", at("gcn.npz"),
                      "--epochs", "500", "--lr", "1e-3", "--log", at("gcn.jsonl"),
                      "--log-every", "100"], [])
    with open(at("gcn.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    log(f"cli train-gcn JSONL loss {lines[0]['loss']:.5f} (step {lines[0]['step']}) -> "
        f"{lines[-1]['loss']:.5f} (step {lines[-1]['step']})")
    if not lines[-1]["loss"] < lines[0]["loss"]:
        raise AssertionError("cli train-gcn did not lower the loss")
    for label, params in (("evaluate", at("gcn.npz")),
                          ("evaluate gcn0", os.path.join(EXP100, "gcn0_params.npz"))):
        out_dir = at("preds" if label == "evaluate" else "preds_gcn0")
        run(label, ["evaluate", params, at("graph_0.npz"), at("graph_1.npz"), "--scenes-dir",
                    at("scenes"), "--imgs-dir", at("big"), "--out-dir", out_dir, *big],
            ["render_fwd"])
        with zipfile.ZipFile(out_dir + ".zip") as zf:
            if len(zf.namelist()) != 4:
                raise AssertionError(f"{out_dir}.zip holds {zf.namelist()}")
    run("graph-viz", ["graph-viz", scene0, at("big", "0.png"), at("viz"), *big], ["inverse_grid"])
    mesh = read_ply_counts(at("viz", "mesh.ply"))
    art = {n: read_ply_counts(os.path.join(REPO, "artifacts", "graphviz", f"{n}.ply"))
           for n in ("mesh", "lines")}
    edges = read_ply_counts(at("viz", "lines.ply"))["edge"]
    want_edges = int((w0[:30] > 1e-3).sum())
    log(f"cli graph-viz: mesh {mesh} (artifact {art['mesh']}), {edges} edges (entries of the "
        f"port's w[:30] above p_min: {want_edges}; artifact lines.ply: {art['lines']['edge']})")
    if mesh != art["mesh"] or edges != want_edges:
        raise AssertionError("cli graph-viz wrote the wrong counts")
    small = size(64, 8, 8)
    for i in range(2):
        run(f"render scene {i} 64x64", ["render", at("scenes", f"{i}.txt"),
                                        at("small", f"{i}.png"), *small], ["render_fwd"])
    run("recover", ["recover", scene0, at("small", "0.png"), "--steps", "10", "--out",
                    at("kd.npy"), *small], ["render_fwd", "render_bwd_grad"])
    run("recover-batch 2", ["recover-batch", "2", "--scenes-dir", at("scenes"), "--imgs-dir",
                            at("small"), "--steps", "10", "--out", at("kd_batch.npy"), *small],
        ["render_fwd", "render_bwd_grad"])
    run("make-dataset 2", ["make-dataset", "2", "--scenes-dir", at("scenes"), "--imgs-dir",
                           at("big"), "--out", at("data.npz"), *big], ["inverse_grid"])
    kd, kd_b = np.load(at("kd.npy")), np.load(at("kd_batch.npy"))
    with np.load(at("data.npz")) as d:
        w_shape = d["w"].shape
    if (kd.shape != (30, 3) or kd_b.shape != (2, 30, 3) or w_shape != (2, 31, 30)
            or not (np.isfinite(kd).all() and np.isfinite(kd_b).all())):
        raise AssertionError(f"cli outputs: kd {kd.shape}, batch {kd_b.shape}, w {w_shape}")
    log("cli wall times (s): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return times


# Phase 24: the render of a scene with its BVH attached (the parity checks' size).
BVH_CHECK = dict(width=64, height=64, spp=4, max_bounces=8)
# Phase 25: the two-process CLI recovery (the JAX test_multihost recipe at
# the card's parity size).
SHARD_CLI = dict(width=64, height=64, spp=8, max_bounces=16)
# Timeout of every process phase 25 starts, in seconds.
PROC_TIMEOUT = 300


def median_ms(fn, runs: int) -> list:
    """CUDA-event times (ms) of `runs` calls of fn after one warm-up."""
    fn()
    return [cuda_ms(fn, 1) for _ in range(runs)]


def host_ms(fn, runs: int) -> list:
    """Host times (ms) of `runs` calls of fn (host-only work)."""
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def fmt(ts) -> str:
    ts = sorted(ts)
    return f"median {ts[len(ts) // 2]:.3f} ms (runs {', '.join(f'{t:.3f}' for t in ts)})"


def random_box_rays(n, seed, device):
    """Rays from points inside the large scene's box, directions uniform on
    the sphere (the JAX package's tests/test_bvh.py _random_rays at origin
    (0, 0, 4), spread 1.8), (n, 3) each."""
    import numpy as np
    import torch

    g = np.random.default_rng(seed)
    p = g.uniform(-1.8, 1.8, size=(n, 3)) + np.array([0.0, 0.0, 4.0])
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(p.astype(np.float32)).to(device),
            torch.from_numpy(d.astype(np.float32)).to(device))


def kernel_counters():
    """Every wrapper's launch counter, by kernel name of the kernels line."""
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        inverse_tile,
        inverse_tile_global,
        inverse_tile_rec,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        bvh_traversal,
        grad_tile,
        intersect_tile,
        render_tile,
        render_tile_rec,
        reverse_tile,
    )
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        init_tile,
        stage_reverse_tile,
        stage_tile,
    )

    return {"bvh_traversal": bvh_traversal,"render_fwd": render_tile, "render_fwd_rec": render_tile_rec,
            "render_bwd_grad": grad_tile, "render_bwd_reverse": reverse_tile,
            "inverse_grid": inverse_tile, "inverse_rec": inverse_tile_rec,
            "inverse_global": inverse_tile_global, "init_tile": init_tile,
            "stage_tile": stage_tile, "stage_reverse_tile": stage_reverse_tile,
            "cluster_sweep": intersect_tile}


def bvh_phase(device):
    """Phase 24: the native bridge and the BVH on the large scene.  The
    native library builds (its g++ time printed); native and Python OBJ
    parses of the in-repo assets and the generated sphere are equal, and
    native and Python BVH builds of the large scene are equal, both timed
    (host ms).  intersect_bvh on 2^20 rays on the card (the large render's
    first camera launch, and random rays from inside the box): hit and tri
    equal to the dense plain sweep's, t within rtol 1e-5 (bit-equal
    printed), timed with CUDA events beside B10 alone (intersect_tile,
    clustered tables) and the dense plain sweep.  Then the render at
    64x64/4 spp/8 bounces of the scene with its BVH attached: bit-equal to
    the scene without it, through the kernels (counted)."""
    import glob

    import numpy as np
    import torch

    from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, large_scene, render_samples
    from inverse_path_tracer_torch.assets import SPHERE_RINGS, SPHERE_SEGMENTS
    from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
    from inverse_path_tracer_torch.ops.bvh import BVHData, build_bvh, intersect_bvh
    from inverse_path_tracer_torch.ops.camera import camera_rays
    from inverse_path_tracer_torch.ops.intersect import intersect_fast
    from inverse_path_tracer_torch.ops.kernels.clusters import kernel_perm
    from inverse_path_tracer_torch.ops.kernels.render_kernel import intersect_tile, pack_tables
    from inverse_path_tracer_torch.scene import obj_loader
    from inverse_path_tracer_torch.utils import native

    t_phase = time.perf_counter()
    if not native.native_available():
        raise AssertionError(f"the native library did not build: {native.build_error()}")
    built = (f"{native.build_seconds:.3f} s of g++" if native.build_seconds is not None
             else "already built")
    log(f"native library: {os.path.relpath(native.library_path(), REPO)} ({built})")
    os.makedirs(OUT_DIR, exist_ok=True)
    sphere = os.path.join(OUT_DIR, "sphere.obj")
    with open(sphere, "w") as f:
        f.write(sphere_obj_text(SPHERE_RINGS, SPHERE_SEGMENTS, normals=True))
    objs = sorted(glob.glob(os.path.join(ASSET_ROOT, "**", "*.obj"), recursive=True)) + [sphere]
    for path in objs:
        py, nat = obj_loader.load_obj(path, use_native=False), native.load_obj_native(path)
        same = all(np.array_equal(getattr(py, k), getattr(nat, k))
                   for k in ("vertices", "normals", "faces", "face_normals_idx"))
        same = same and py.material_names == nat.material_names and py.mtllibs == nat.mtllibs
        log(f"obj {os.path.basename(path)}: {py.faces.shape[0]} faces, native = python {same}")
        if not same:
            raise AssertionError(f"native and Python OBJ parses of {path} differ")
    parse_py = host_ms(lambda: obj_loader.load_obj(sphere, use_native=False), 3)
    parse_nat = host_ms(lambda: native.load_obj_native(sphere), 5)
    log(f"obj parse of the 1280-triangle sphere: python {fmt(parse_py)}, native {fmt(parse_nat)}")

    scene = large_scene()
    bvh_py = build_bvh(scene, use_native=False)
    bvh_nat = build_bvh(scene, use_native=True)
    same = all(torch.equal(getattr(bvh_py, k), getattr(bvh_nat, k)) for k in BVHData._fields)
    t_py = host_ms(lambda: build_bvh(scene, use_native=False), 3)
    t_nat = host_ms(lambda: build_bvh(scene, use_native=True), 5)
    log(f"BVH of the large scene ({scene.n_tri} triangles, {bvh_py.n_nodes} nodes): native = "
        f"python {same}; python {fmt(t_py)}, native {fmt(t_nat)} (host)")
    if not same:
        raise AssertionError("native and Python BVH builds differ")

    cfg = RenderConfig(**MAIN)
    scene_d = scene.to(device)
    bvh = bvh_nat.to(device)
    n = 1 << 20
    tabs = pack_tables(scene_d, scene_d.diffuse, cfg)
    perm = kernel_perm(scene_d, cfg)
    idx = torch.arange(n, device=device)
    rays = {"camera": camera_rays(scene_d, cfg, 0, idx), "box": random_box_rays(n, 5, device)}
    result = {}
    for name, (p, d) in rays.items():
        got = intersect_bvh(scene_d, bvh, p, d)
        want = intersect_fast(scene_d, p, d)
        hits = want.hit
        ok = (torch.equal(got.hit, want.hit) and torch.equal(got.tri[hits], want.tri[hits])
              and torch.allclose(got.t[hits], want.t[hits], rtol=1e-5, atol=0.0))
        bit = torch.equal(got.t, want.t) and torch.equal(got.tri, want.tri)
        t_k, i_k = intersect_tile(scene_d, cfg, p.T.contiguous(), d.T.contiguous(), tables=tabs)
        tri_k = perm[i_k.long()] if perm is not None else i_k.long()
        b10_same = float(((tri_k == got.tri) & hits).sum()) / max(int(hits.sum()), 1)
        t_bvh = median_ms(lambda: intersect_bvh(scene_d, bvh, p, d), 3)
        pt, dt = p.T.contiguous(), d.T.contiguous()
        t_b10 = median_ms(lambda: intersect_tile(scene_d, cfg, pt, dt, tables=tabs), 5)
        t_dense = median_ms(lambda: intersect_fast(scene_d, p, d), 3)
        ratio = sorted(t_bvh)[1] / sorted(t_b10)[2]
        log(f"intersect_bvh, {name} rays (2^20, {int(hits.sum())} hits): hit/tri equal to the "
            f"dense plain sweep and t rtol 1e-5 {ok} (bit-equal {bit}); B10's triangle the "
            f"BVH's on {100 * b10_same:.4f}% of hits")
        log(f"  intersect_bvh {fmt(t_bvh)}; B10 intersect_tile (clustered, k="
            f"{tabs.cluster_k}) {fmt(t_b10)}; dense plain sweep {fmt(t_dense)}; "
            f"bvh / B10 {ratio:.1f}x ({time.perf_counter() - t_phase:.1f} s into phase 24)")
        if not ok:
            raise AssertionError(f"intersect_bvh differs from the dense sweep on {name} rays")
        result[name] = (t_bvh, t_b10, t_dense)

    # With intersect "auto" the renders do not read the BVH: a scene that
    # carries one renders through the kernels, bit-equal to the scene
    # without it.
    rcfg = RenderConfig(**BVH_CHECK)
    scene_b = scene_d.replace(bvh=bvh)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    got, st = render_samples(scene_b.diffuse, scene_b, 3, rcfg, device=device)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    want, st_w = render_samples(scene_d.diffuse, scene_d, 3, rcfg, device=device)
    same = torch.equal(got, want) and int(st.segments) == int(st_w.segments)
    log(f"render {shape(rcfg)} of the scene with its BVH attached against the scene without: "
        f"bit-equal {same}, segments {int(st.segments)} = {int(st_w.segments)}; kernel launches "
        f"{launched or 'none'}; {t_render:.2f} s (wall)")
    if not same:
        raise AssertionError("the scene with a BVH renders differently")
    if not launched:
        raise AssertionError("the render of a scene with a BVH launched no kernel")
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s")
    return result


# Phase 27's clustered B2 against its plain version on the 20,498-triangle
# scene: 131,072 lanes, past the 264-block grid of the accumulators in
# global memory (the plain clustered sweep loops over 1282 clusters).
BVH_PLAIN_CHECK = dict(width=128, height=128, spp=8, max_bounces=4)


def bvh_route_phase(device):
    """Phase 27 (run after phase 24): the BVH route (RenderConfig
    intersect="bvh") on the 20,498-triangle scene (assets.bvh_scene: the
    box and a vertex-normal sphere of 20,480 triangles, its BVH built by
    the native library).  The traversal kernel (intersect_tile on BVH
    tables) on 2^20 rays (the main path's first camera launch, and random
    rays from inside the box) against the plain intersect_bvh and B10's
    clustered sweep on the same rays: hit and t bit for bit, the triangle
    the plain traversal's, and B10's wherever B10's internal order does not
    break an exact tie the other way (then the BVH's global index is the
    lower), the nodes visited, the box and triangle tests and the visits
    culled by their stored entry distance of kernel and plain version
    equal, the box tests one a ray and two an inner node entered, both
    times printed.  B1's BVH instance timed at the 1298-triangle scene's
    first 2^20-sample launch (MAIN, the `render_bvh` cell's scene) beside
    B1 clustered there (lanes within the vertex-normal bound printed).
    render_samples and
    loss_and_grad_range at 64x64/4 spp/8 bounces through the route against
    the clustered mega route: at least 97% of lanes within rtol 1e-4 /
    atol 1e-5 (the share bit-equal printed), counts equal and the gradients
    under the vertex-normal bound of phase 16.  Past 2048 triangles (their
    accumulators in global memory, on grids cut to 2 blocks an SM) against
    their plain versions, each twice bit-equal: B2 on the route and B4 on
    the route's B3 records at the main path's first launch (2^20 lanes, 16
    bounces), B9 on 2^20 lanes of a stage's records, the clustered B2 at
    BVH_PLAIN_CHECK.  The FD gate of phase 8 through the route.  The main
    path: render_samples, fwd+bwd and loss_and_grad_range at 512x512/64
    spp/16 bounces on the route (counted from 0: B1, B2, B3, B4 and the
    traversal), then on the scene's default route (counted from 0: B7, B8,
    B9 and the clustered sweep) against the clustered mega route; all three
    routes timed, 1 warm-up and 2 timed runs each; a profile of the route's
    fwd+bwd with every plain version refused, the traversal's kernels
    present and no device-to-host copy.  Returns the traversal's
    kernels-line entry."""
    import torch

    from inverse_path_tracer_torch import (
        RenderConfig,
        bvh_scene,
        large_scene,
        loss_and_grad_range,
        render_samples,
    )
    from inverse_path_tracer_torch.ops.bvh import attach_bvh
    from inverse_path_tracer_torch.ops.camera import camera_rays
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        grad_tile,
        grad_tile_plain,
        intersect_tile,
        intersect_tile_plain,
        pack_tables,
        render_tile,
        render_tile_rec,
        reverse_tile,
        reverse_tile_plain,
    )
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        stage_reverse_tile,
        stage_reverse_tile_plain,
    )
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene = bvh_scene(device, use_native=True)
    nt, mats = scene.n_tri, scene.diffuse
    cfg = RenderConfig(**MAIN)
    route, sweep_route = cfg.with_(intersect="bvh"), cfg.with_(wavefront="mega")
    tabs_b, tabs_c = pack_tables(scene, mats, route), pack_tables(scene, mats, sweep_route)
    log(f"BVH route scene: {nt} triangles, {scene.bvh.n_nodes} nodes, leaves of at most "
        f"{int(scene.bvh.n_prims.max())}; built and packed in {time.perf_counter() - t0:.2f} s; "
        f"clustered tables of {tabs_c.cluster_k}, {-(-nt // tabs_c.cluster_k)} clusters")

    # The traversal alone against the plain traversal and B10.
    n = 1 << 20
    rays = {"camera": camera_rays(scene, cfg, 0, torch.arange(n, device=device)),
            "box": random_box_rays(n, 5, device)}
    entry = None
    for name, (p, d) in rays.items():
        pt, dt = p.T.contiguous(), d.T.contiguous()
        c_k = torch.zeros(4, dtype=torch.int64, device=device)
        c_p = torch.zeros(4, dtype=torch.int64, device=device)
        t_k, i_k = intersect_tile(scene, route, pt, dt, tables=tabs_b, counts=c_k)
        t_p, i_p = intersect_tile_plain(scene, route, pt, dt, counts=c_p)
        t_c, i_c = intersect_tile(scene, sweep_route, pt, dt, tables=tabs_c)
        hit = torch.isfinite(t_k)
        g_k, g_c = tabs_b.perm[i_k.long()], tabs_c.perm[i_c.long()]
        tie = hit & (g_k != g_c)
        plain_ok = torch.equal(t_k, t_p) and torch.equal(i_k, i_p) and torch.equal(c_k, c_p)
        b10_ok = (torch.equal(t_k, t_c) and torch.equal(hit, torch.isfinite(t_c))
                  and bool((g_k[tie] < g_c[tie]).all()))
        ms = median_ms(lambda: intersect_tile(scene, route, pt, dt, tables=tabs_b), 5)
        ms_c = median_ms(lambda: intersect_tile(scene, sweep_route, pt, dt, tables=tabs_c), 5)
        nodes, boxes, tris, culled = (int(v) for v in c_k.tolist())
        inner, odd = divmod(boxes - n, 2)
        counts_ok = odd == 0 and nodes - n <= 2 * inner and inner + culled <= nodes
        log(f"traversal, {name} rays (2^20, {int(hit.sum())} hits): kernel = plain intersect_bvh "
            f"(t, triangle, counts) {plain_ok}; = B10 clustered (hit, t bit for bit, triangle "
            f"but {int(tie.sum())} exact ties broken by a lower global index) {b10_ok}; "
            f"{nodes} nodes visited, {boxes} box tests (rays + 2 x {inner} inner nodes entered "
            f"{counts_ok}), {tris} triangle tests, {culled} visits culled "
            f"({nodes / n:.2f}, {boxes / n:.2f}, {tris / n:.2f}, {culled / n:.2f} a ray)")
        log(f"  traversal kernel {fmt(ms)}; B10 clustered {fmt(ms_c)}")
        if not (plain_ok and b10_ok and counts_ok):
            raise AssertionError(f"the traversal kernel's hits or counts differ on {name} rays")
        if entry is None:
            plain_ms = cuda_ms(lambda: intersect_tile_plain(scene, route, pt, dt), 1)
            # A triangle test at the sweep's face-plane count, as B10's.
            t_ops = (boxes * BOX_OPS + tris * FACE_PLANE_OPS) / PEAK_F32_OPS * 1e3
            t_bytes = n * (6 + 2) * 4 / PEAK_BYTES * 1e3  # rays in, t and triangle out
            b_ms, b_by = bound(t_ops, t_bytes)
            entry = {"name": "bvh_traversal", "route": "cuda",
                     "source": "inverse_path_tracer_torch/ops/kernels/" + KERNELS[
                         "bvh_traversal"][0],
                     "replaces": KERNELS["bvh_traversal"][1],
                     "launches": 0, "max_abs_err": float((t_k - t_p).nan_to_num().abs().max()),
                     "ms": sorted(ms)[len(ms) // 2], "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
            log(f"  traversal on the camera launch: plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms "
                f"({b_by}), {100 * b_ms / entry['ms']:.2f}% of bound")
    del rays

    # B1's BVH instance at the 1298-triangle scene's first launch, beside B1
    # clustered on the same launch.
    large = attach_bvh(large_scene(device))
    a1 = camera_launch(n, 1)
    tabs_1b = pack_tables(large, large.diffuse, route)
    tabs_1c = pack_tables(large, large.diffuse, sweep_route)
    b1 = {"bvh": lambda: render_tile(large.diffuse, large, route, tables=tabs_1b, **a1),
          "clustered": lambda: render_tile(large.diffuse, large, sweep_route, tables=tabs_1c, **a1)}
    (rb, sb), (rc, sc) = b1["bvh"](), b1["clustered"]()
    share, err = lanes_equal(rb, rc, True)
    b1_ms = {key: median_ms(fn, 5) for key, fn in b1.items()}
    log(f"B1 at the 1298-triangle scene's first launch ({shape(cfg)}, 2^20 samples): BVH "
        f"{fmt(b1_ms['bvh'])}; clustered {fmt(b1_ms['clustered'])}; {share:.5f} of lanes within "
        f"rtol 1e-4 (max |d| {err:.3e}), segments {int(sb[0].sum())} and {int(sc[0].sum())}")
    if share < 0.97:
        raise AssertionError("B1's BVH instance differs from B1 clustered on the 1298 scene")
    del large, tabs_1b, tabs_1c, rb, sb, rc, sc

    # The route against the clustered mega route.
    ccfg = RenderConfig(**BVH_CHECK)
    w = torch.rand((ccfg.n_samples, 3), generator=torch.Generator().manual_seed(4)).to(device)
    outs = {}
    for what, c in (("bvh", ccfg.with_(intersect="bvh")), ("clustered", ccfg.with_(wavefront="mega"))):
        m = mats.clone().requires_grad_()
        vals, st = render_samples(m, scene, 3, c, device=device)
        (vals * w).sum().backward()
        loss, g_lg, st_lg = loss_and_grad_range(mats, scene, 3, c, 0, c.n_samples,
                                                lambda v, lo: (v * w[lo:lo + v.shape[0]]).sum(),
                                                device=device)
        outs[what] = (vals.detach(), st, m.grad, g_lg, st_lg)
    (vb, sb, gb, lb, slb), (vc, sc, gc, lc, slc) = outs["bvh"], outs["clustered"]
    share, err = lanes_equal(vb.T, vc.T, True)
    bit = float((vb == vc).all(dim=1).float().mean())
    counts_ok = all(int(x.segments) == int(y.segments) and int(x.shadow_rays) == int(y.shadow_rays)
                    for x, y in ((sb, sc), (slb, slc)))
    ok = share >= 0.97 and counts_ok and vn_grad_close(gb, gc) and vn_grad_close(lb, lc)
    log(f"route against the clustered mega route {shape(ccfg)}: {share:.5f} of lanes within rtol "
        f"1e-4 ({bit:.5f} bit-equal, {1 - bit:.5f} differ; max |d| {err:.3e}); counts equal "
        f"{counts_ok}; autograd gradient max |d| {float((gb - gc).abs().max()):.3e}, "
        f"loss_and_grad_range's {float((lb - lc).abs().max()):.3e} -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the BVH route differs from the clustered route")

    # B2, B4 and B9 past 2048 triangles against their plain versions, on
    # grids cut to 2 blocks an SM: B2 on the route and B4 on the route's B3
    # records at the main path's first launch, B9 on as many lanes of a
    # stage's records, the clustered B2 at BVH_PLAIN_CHECK.
    n_main = 1 << 20
    a = camera_launch(n_main, 6)
    g = torch.rand((3, n_main), generator=torch.Generator().manual_seed(7)).to(device)
    t0 = time.perf_counter()
    checks, errs, grids = {}, {}, {}

    def hold(key, got, again, want, close, blocks):
        checks[key] = close(got, want) and torch.equal(got, again)
        errs[key] = float((got - want).abs().max())
        grids[key] = blocks

    d2 = grad_tile(mats, scene, route, g=g, tables=tabs_b, **a)
    hold("B2 BVH route", d2, grad_tile(mats, scene, route, g=g, tables=tabs_b, **a),
         grad_tile_plain(mats, scene, route, g=g, **a), vn_grad_close, grad_tile.blocks)
    _, _, rec = render_tile_rec(mats, scene, route, tables=tabs_b, **a)
    d4 = reverse_tile(nt, route, rec, g, tabs_b.perm)
    hold("B4", d4, reverse_tile(nt, route, rec, g, tabs_b.perm),
         reverse_tile_plain(nt, route, rec, g, tabs_b.perm), grad_close, reverse_tile.blocks)
    del rec
    k = 4
    rec9, g9, suf9 = b9_records(device, nt, k, n_main)
    d9, s9 = stage_reverse_tile(nt, cfg, k, rec9, g9, suf9)
    d9b, s9b = stage_reverse_tile(nt, cfg, k, rec9, g9, suf9)
    d9p, s9p = stage_reverse_tile_plain(nt, cfg, k, rec9, g9, suf9)
    hold("B9", d9, d9b, d9p, grad_close, stage_reverse_tile.blocks)
    checks["B9"] = (checks["B9"] and torch.equal(s9, s9b)
                    and bool(torch.allclose(s9, s9p, rtol=1e-5, atol=1e-6)))
    del rec9, g9, suf9
    pcfg = RenderConfig(**BVH_PLAIN_CHECK).with_(wavefront="mega")
    ac = camera_launch(pcfg.n_samples, 6)
    g_c = g[:, :pcfg.n_samples].contiguous()
    tabs = pack_tables(scene, mats, pcfg)
    d2c = grad_tile(mats, scene, pcfg, g=g_c, tables=tabs, **ac)
    hold("B2 clustered", d2c, grad_tile(mats, scene, pcfg, g=g_c, tables=tabs, **ac),
         grad_tile_plain(mats, scene, pcfg, g=g_c, **ac), vn_grad_close, grad_tile.blocks)
    ok = all(checks.values())
    log(f"gradient kernels past 2048 triangles ({nt}; accumulators in global memory) against "
        f"their plain versions, twice bit-equal: B2 on the route, B4 and B9 at 2^20 lanes "
        f"({shape(cfg)}'s first launch), B2 clustered {shape(pcfg)}: "
        + ", ".join(f"{key} {v} (max |d| {errs[key]:.3e}, {grids[key]} blocks)"
                    for key, v in checks.items())
        + f"; {time.perf_counter() - t0:.1f} s -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a gradient kernel past 2048 triangles disagrees with its plain "
                             "version")

    fd_gate(device, scene, mats, label="20,498-triangle scene (BVH route)",
            cfg=RenderConfig(**FD).with_(intersect="bvh"))

    # The main path on both routes.
    n_values = cfg.width * cfg.height * 3

    def forward(c):
        return lambda key: render_samples(mats, scene, key, c, device=device)

    def fwd_bwd(c):
        def run(key):
            m = mats.clone().requires_grad_()
            v, st = render_samples(m, scene, key, c, device=device)
            tonemap_mean(v, c.spp).mean().backward()
            return m.grad, st
        return run

    def lg(c):
        return lambda key: loss_and_grad_range(
            mats, scene, key, c, 0, c.n_samples,
            lambda v, lo: tonemap_mean(v, c.spp).sum() / n_values, device=device)

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    vals, stats = forward(route)(0)
    grad_fb, _ = fwd_bwd(route)(0)
    _, grad_lg, _ = lg(route)(0)
    torch.cuda.synchronize()
    launched = {key: c.launches for key, c in counters.items() if c.launches}
    need = ("render_fwd", "render_bwd_grad", "render_fwd_rec", "render_bwd_reverse",
            "bvh_traversal")
    finite = all(bool(torch.isfinite(x).all()) for x in (vals, grad_fb, grad_lg))
    mean = float(vals.mean())
    ok = (all(launched.get(key, 0) for key in need) and finite and 0.05 < mean < 50.0
          and float(grad_fb.abs().sum()) > 0
          and bool(torch.allclose(grad_lg, grad_fb, rtol=1e-5, atol=0))
          and not any(key in launched for key in ("init_tile", "stage_tile",
                                                  "stage_reverse_tile", "cluster_sweep")))
    log(f"BVH route main path {shape(cfg)}: launches {launched}; segments "
        f"{int(stats.segments)}, shadow rays {int(stats.shadow_rays)}, mean radiance {mean:.5f}; "
        f"loss_and_grad_range = autograd's rtol 1e-5 (bit-equal {torch.equal(grad_lg, grad_fb)})"
        f" -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the BVH route's main path failed its checks: {launched}")
    entry["launches"] = launched["bvh_traversal"]

    # The default route on this scene (intersect "auto": the clustered
    # sweep, staged), counted from 0, against the clustered mega route.
    for c in counters.values():
        c.launches = 0
    st_vals, st_stats = forward(cfg)(0)
    st_fb, _ = fwd_bwd(cfg)(0)
    _, st_lg, _ = lg(cfg)(0)
    torch.cuda.synchronize()
    st_launched = {key: c.launches for key, c in counters.items() if c.launches}
    mg_vals, mg_stats = forward(sweep_route)(0)
    mg_fb, _ = fwd_bwd(sweep_route)(0)
    _, mg_lg, _ = lg(sweep_route)(0)
    share, err = lanes_equal(st_vals.T, mg_vals.T, True)
    finite = all(bool(torch.isfinite(x).all()) for x in (st_vals, st_fb, st_lg))
    ok = (all(st_launched.get(key, 0) for key in ("init_tile", "stage_tile", "stage_reverse_tile",
                                                  "cluster_sweep"))
          and "bvh_traversal" not in st_launched and finite and share >= 0.97
          and float(st_fb.abs().sum()) > 0 and vn_grad_close(st_fb, mg_fb)
          and vn_grad_close(st_lg, mg_lg))
    log(f"staged clustered route (intersect auto) {shape(cfg)}: launches {st_launched}; segments "
        f"{int(st_stats.segments)} (mega {int(mg_stats.segments)}), shadow rays "
        f"{int(st_stats.shadow_rays)} (mega {int(mg_stats.shadow_rays)}); against the clustered "
        f"mega route: {share:.5f} of lanes within rtol 1e-4 (bit-equal "
        f"{torch.equal(st_vals, mg_vals)}, max |d| {err:.3e}), fwd+bwd gradient max |d| "
        f"{float((st_fb - mg_fb).abs().max()):.3e}, loss_and_grad_range's "
        f"{float((st_lg - mg_lg).abs().max()):.3e} -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the staged route on the 20,498-triangle scene failed: {st_launched}")
    del st_vals, mg_vals
    # The scratch of the accumulators in global memory at the main path's
    # grids: (blocks, warps, nT, 3) floats.
    log(f"accumulator scratch at {nt} triangles: B2 {grad_tile.blocks} blocks x 8 warps = "
        f"{grad_tile.blocks * 8 * nt * 3 * 4} bytes, B4 {reverse_tile.blocks} blocks x 8 warps = "
        f"{reverse_tile.blocks * 8 * nt * 3 * 4} bytes (the launch's partials "
        f"{grad_tile.blocks * nt * 3 * 4} and {reverse_tile.blocks * nt * 3 * 4} bytes)")
    stats_of = {"forward": lambda o: o[1], "fwd+bwd": lambda o: o[1], "loss_and_grad_range":
                lambda o: o[2]}
    for what, make in (("forward", forward), ("fwd+bwd", fwd_bwd), ("loss_and_grad_range", lg)):
        for label, c in (("BVH route", route), ("clustered mega", sweep_route),
                         ("clustered staged", cfg)):
            fn = make(c)
            fn(1)  # warm-up
            for k in range(2):
                out = []
                t = cuda_ms(lambda: out.append(fn(k + 2)), 1)
                st = stats_of[what](out[0])
                rays_n = int(st.segments) + int(st.shadow_rays)
                log(f"{what} {label} {shape(cfg)} run {k}: {t:.3f} ms, rays {rays_n}, "
                    f"{rays_n / (t / 1e3):.6e} rays/s")
    with no_plain_versions():
        prof, calls = profile_once("one BVH-route fwd+bwd", lambda: fwd_bwd(route)(7),
                                   ops=CAMERA_OPS + ("aten::_local_scalar_dense",))
    names = list(prof)
    traversal = [nm for nm in names if ("render_kernel<" in nm or "grad_tile_kernel<" in nm)
                 and ", 2>" in nm]
    dtoh = [nm for nm in names if "DtoH" in nm]
    log(f"BVH-route fwd+bwd profile: traversal kernels {traversal}; device-to-host copies "
        f"{dtoh or 'none'}, .item() calls {calls['aten::_local_scalar_dense']}")
    if prof and (not traversal or dtoh or calls["aten::_local_scalar_dense"]):
        raise AssertionError("the BVH route's fwd+bwd ran no traversal kernel or copied to the host")
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s")
    return entry


def b9_records(device, n_tri, k, n):
    """Records of a k-slot stage for n lanes over n_tri triangles, made with
    numpy from a seed (path lengths 0 to k, the last slot an escape for ~30%
    of them), with g (3, n) and a random (suf, esc) carry (4, n): B9's
    inputs past 2048 triangles."""
    import numpy as np
    import torch

    from inverse_path_tracer_torch.render.diff import REC_ROWS

    r = np.random.default_rng(29)
    lengths = r.integers(0, k + 1, size=n)
    rec = np.zeros((k, REC_ROWS, n), dtype=np.float32)
    for s in range(k):
        on = lengths > s
        rec[s, :13, on] = r.random((int(on.sum()), 13), dtype=np.float32)
        rec[s, 13, on] = r.integers(0, n_tri, size=int(on.sum()))
        esc = on & (lengths == s + 1) & (r.random(n) < 0.3)
        rec[s, 14, on & ~esc] = 1.0
        rec[s, 15, esc] = 1.0
        rec[s, 0:3, esc] = 0.0
        rec[s, 6:9, esc] = 0.0
    g = r.random((3, n), dtype=np.float32)
    suf = r.random((4, n), dtype=np.float32)
    suf[3] = (suf[3] > 0.5).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (rec.reshape(k * REC_ROWS, n), g, suf))


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def shard_steps(mesh, device, n_steps: int):
    """n_steps sharded Adam steps (lr 0.1) from theta = 0 on scene 0 at the
    main configuration against a render at a scaled Kd: the losses, the
    gradient and theta after each step, and each step's wall time (ms,
    synchronized)."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, render_image
    from inverse_path_tracer_torch.models.recover import make_optimizer
    from inverse_path_tracer_torch.parallel.shard import make_recover_step

    cfg = RenderConfig(**MAIN)
    scene, mats = fixture(device)
    target = render_image(mats * 0.6, scene, 50, cfg, device=device)
    theta = torch.zeros_like(mats, requires_grad=True)
    step = make_recover_step(scene, cfg, mesh, make_optimizer(theta, 0.1))
    losses, grads, thetas, times = [], [], [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(theta, 60 + i, target))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        grads.append(theta.grad.detach().cpu().clone())
        thetas.append(theta.detach().cpu().clone())
    return losses, grads, thetas, times


def shard_worker(args: dict) -> None:
    """One rank of phase 25's world 2 (python3 chip_smoke.py --shard-worker
    JSON): both ranks on the one card, gloo.  Saves the gathered radiance's
    digest, the counts, the steps' losses, gradients and theta, and the
    wall times to args["out"]."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from inverse_path_tracer_torch import RenderConfig
    from inverse_path_tracer_torch.parallel.multihost import init_distributed, shutdown_distributed
    from inverse_path_tracer_torch.parallel.shard import make_mesh, render_samples_sharded

    info = init_distributed(args["coordinator"], 2, args["rank"])
    mesh = make_mesh()
    log(f"worker rank {mesh.rank}: {info}, device {mesh.device}")
    cfg = RenderConfig(**MAIN)
    scene, mats = fixture(mesh.device)
    out = {}
    vals, st = render_samples_sharded(mats, scene, 0, cfg, mesh)
    out["digest"] = np.array(_digest(vals))
    out["counts"] = np.array([int(st.segments), int(st.shadow_rays)])
    render_ms = []
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_samples_sharded(mats, scene, k + 1, cfg, mesh)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
    losses, grads, thetas, step_ms = shard_steps(mesh, mesh.device, 3)
    np.savez(args["out"], render_ms=np.array(render_ms), step_ms=np.array(step_ms),
             losses=np.array(losses), grads=torch.stack(grads).numpy(),
             thetas=torch.stack(thetas).numpy(), **out)
    shutdown_distributed()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_together(cmds, label):
    """Start every command at once, wait for all (PROC_TIMEOUT each), kill
    what is left on any failure; returns their outputs and the wall time."""
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{label} process {i} failed (rc {p.returncode}):\n{out[-4000:]}")
    return outs, dt


def sharded_phase(device):
    """Phase 25: sharded rendering and recovery on the main path (scene 0 at
    512x512/64 spp/16 bounces, fused RNG).  World 1, NCCL, in this process:
    render_samples_sharded bit-equal to render_samples with equal counts,
    both timed; one sharded recovery step against recover_step on the same
    theta (loss rtol 1e-6, gradient rtol 1e-5 / atol 1e-8), both timed,
    with B1's and B2's launches; 3 sharded steps for world 2 to match.
    World 2, two processes on the one card (gloo), started at once: the
    gathered radiance and counts equal world 1's bit for bit, theta
    bit-identical on both ranks after 3 steps, the losses rtol 1e-6 and the
    gradients rtol 1e-5 / atol 1e-8 of world 1's, theta within rtol 1e-4 /
    atol 1e-6 of world 1's; wall time per call.  Then the CLI as the JAX
    package's test_multihost: two processes of cli recover --shard
    --coordinator at 64x64/8 spp, both in a group of 2, their --out
    bit-identical, of shape (30, 3)."""
    import numpy as np
    import torch

    from inverse_path_tracer_torch import RenderConfig, render_image, render_samples
    from inverse_path_tracer_torch.models.recover import make_optimizer, recover_step
    from inverse_path_tracer_torch.ops.kernels.render_kernel import grad_tile, render_tile
    from inverse_path_tracer_torch.parallel.multihost import init_distributed, shutdown_distributed
    from inverse_path_tracer_torch.parallel.shard import make_mesh, make_recover_step, \
        render_samples_sharded
    from inverse_path_tracer_torch.ops.tonemap import tonemap_to_uint8
    from inverse_path_tracer_torch.utils.png import write_png

    t_phase = time.perf_counter()
    info = init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    mesh = make_mesh()
    log(f"world 1: {info}, mesh rank {mesh.rank} of {mesh.size} on {mesh.device}")
    if info["backend"] != "nccl":
        raise AssertionError(f"world 1 on a card chose {info['backend']}, not nccl")
    cfg = RenderConfig(**MAIN)
    scene, mats = fixture(device)
    vals, st = render_samples_sharded(mats, scene, 0, cfg, mesh)
    ref, st_r = render_samples(mats, scene, 0, cfg, device=device)
    same = torch.equal(vals, ref) and [int(st.segments), int(st.shadow_rays)] == \
        [int(st_r.segments), int(st_r.shadow_rays)]
    digest1, counts1 = _digest(vals), [int(st.segments), int(st.shadow_rays)]
    del vals, ref
    t_sh = median_ms(lambda: render_samples_sharded(mats, scene, 1, cfg, mesh), 3)
    t_un = median_ms(lambda: render_samples(mats, scene, 1, cfg, device=device), 3)
    log(f"world 1 render {shape(cfg)}: sharded = render_samples bit for bit, counts equal "
        f"{same}; sharded {fmt(t_sh)}, render_samples {fmt(t_un)}")
    if not same:
        raise AssertionError("the world-1 sharded render differs from render_samples")

    target = render_image(mats * 0.6, scene, 50, cfg, device=device)
    theta_a = torch.full_like(mats, 0.3).requires_grad_()
    theta_b = theta_a.detach().clone().requires_grad_()
    step = make_recover_step(scene, cfg, mesh, make_optimizer(theta_a, 0.1))
    opt_b = make_optimizer(theta_b, 0.1)
    render_tile.launches = grad_tile.launches = 0
    loss_a = step(theta_a, 61, target)
    torch.cuda.synchronize()
    launches = {"render_fwd": render_tile.launches, "render_bwd_grad": grad_tile.launches}
    loss_b = recover_step(theta_b, opt_b, scene, 61, cfg, target, device=device)
    ok = (math.isclose(loss_a, loss_b, rel_tol=1e-6)
          and torch.allclose(theta_a.grad, theta_b.grad, rtol=1e-5, atol=1e-8))
    log(f"world 1 recovery step: loss {loss_a:.8f} against recover_step's {loss_b:.8f}, "
        f"gradient max |d| {float((theta_a.grad - theta_b.grad).abs().max()):.3e} -> "
        f"{'OK' if ok else 'FAIL'}; launches {launches}")
    if not ok or min(launches.values()) == 0:
        raise AssertionError("the world-1 sharded step differs from recover_step or launched "
                             f"no B1/B2 ({launches})")
    t_step = median_ms(lambda: step(theta_a, 62, target), 3)
    t_ref = median_ms(lambda: recover_step(theta_b, opt_b, scene, 62, cfg, target,
                                           device=device), 3)
    log(f"world 1 recovery step {shape(cfg)}: sharded {fmt(t_step)}, recover_step {fmt(t_ref)}")
    losses1, grads1, thetas1, step_ms1 = shard_steps(mesh, device, 3)
    del target
    shutdown_distributed()
    torch.cuda.empty_cache()

    coord = f"127.0.0.1:{free_port()}"
    outs = [os.path.join(OUT_DIR, f"shard_rank{r}.npz") for r in range(2)]
    cmds = [[sys.executable, os.path.join(REPO, "chip_smoke.py"), "--shard-worker",
             json.dumps({"coordinator": coord, "rank": r, "out": outs[r]})] for r in range(2)]
    logs, dt = run_together(cmds, "world-2 worker")
    for text in logs:
        for line in text.strip().splitlines():
            if line.startswith("worker"):
                log(f"  {line}")
    ranks = [dict(np.load(o)) for o in outs]
    same_vals = all(str(r["digest"]) == digest1 and r["counts"].tolist() == counts1
                    for r in ranks)
    same_theta = (np.array_equal(ranks[0]["thetas"], ranks[1]["thetas"])
                  and np.array_equal(ranks[0]["losses"], ranks[1]["losses"]))
    g1, th1 = torch.stack(grads1).numpy(), torch.stack(thetas1).numpy()
    near = (np.allclose(ranks[0]["losses"], losses1, rtol=1e-6, atol=0)
            and np.allclose(ranks[0]["grads"], g1, rtol=1e-5, atol=1e-8)
            and np.allclose(ranks[0]["thetas"], th1, rtol=1e-4, atol=1e-6))
    log(f"world 2 (gloo, one card, 2 processes, {dt:.1f} s wall): radiance and counts = world "
        f"1's bit for bit {same_vals}; theta bit-identical on both ranks {same_theta}; losses, "
        f"gradients and theta within the bars of world 1's {near} (max |d theta| "
        f"{float(np.abs(ranks[0]['thetas'] - th1).max()):.3e})")
    for r, rk in enumerate(ranks):
        log(f"  rank {r}: render_samples_sharded {fmt(rk['render_ms'])} (wall), steps "
            f"{', '.join(f'{t:.1f}' for t in rk['step_ms'])} ms (wall)")
    log(f"  world 1 steps {', '.join(f'{t:.1f}' for t in step_ms1)} ms (wall)")
    if not (same_vals and same_theta and near):
        raise AssertionError("world 2 differs from world 1 or across its ranks")

    work = os.path.join(OUT_DIR, "shard_cli")
    os.makedirs(work, exist_ok=True)
    ccfg = RenderConfig(**SHARD_CLI)
    img = render_image(mats, scene, 9, ccfg, device=device)
    write_png(os.path.join(work, "target.png"), tonemap_to_uint8(img).cpu().numpy())
    coord = f"127.0.0.1:{free_port()}"
    size = ["--width", str(ccfg.width), "--height", str(ccfg.height), "--spp", str(ccfg.spp),
            "--bounces", str(ccfg.max_bounces)]
    cmds = [[sys.executable, "-m", "inverse_path_tracer_torch.cli", "recover",
             os.path.join(REPO, "scenes", "0.txt"), os.path.join(work, "target.png"), "--shard",
             "--coordinator", coord, "--num-processes", "2", "--process-id", str(i),
             "--steps", "5", "--lr", "0.1", "--out", os.path.join(work, f"out{i}.npy"), *size]
            for i in range(2)]
    logs, dt = run_together(cmds, "cli recover --shard")
    for i, text in enumerate(logs):
        log(f"  cli process {i}: " + " | ".join(text.strip().splitlines()))
    kd = [np.load(os.path.join(work, f"out{i}.npy")) for i in range(2)]
    ok = (all("'process_count': 2" in t for t in logs) and kd[0].shape == (30, 3)
          and np.array_equal(kd[0], kd[1]) and bool(np.isfinite(kd[0]).all()))
    log(f"cli recover --shard --coordinator, 2 processes on the card ({dt:.1f} s wall, "
        f"{shape(ccfg)}, 5 steps): both in a group of 2, --out bit-identical (30, 3) {ok}")
    if not ok:
        raise AssertionError("the two-process CLI recovery failed its checks")
    log(f"phase 25: {time.perf_counter() - t_phase:.1f} s")


# Phase 26: the gate's triangles on scene 0 at 256x256 (the JAX run's
# observability_gate_tris, artifacts/exp100/metrics.json).
GATE_TRIS = list(range(16)) + [20, 21, 22, 23]


@contextlib.contextmanager
def no_plain_versions():
    """Every kernel's plain version (the *_plain functions of the kernel
    modules and of the render modules that import them) raises while the
    block runs: a path on the card must launch the kernels."""
    from inverse_path_tracer_torch.ops.kernels import inverse_kernel, render_kernel, staged_kernel
    from inverse_path_tracer_torch.render import forward, inverse

    saved = []

    def refuse(name):
        def fn(*_a, **_kw):
            raise AssertionError(f"{name} (a plain version) ran on the card's path")
        return fn

    for mod in (render_kernel, staged_kernel, inverse_kernel, forward, inverse):
        for name in dir(mod):
            if name.endswith("_plain") and callable(getattr(mod, name)):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, refuse(f"{mod.__name__}.{name}"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def experiments_phase(device):
    """Phase 26: the experiment modules (inverse_path_tracer_torch/experiments)
    on the card.  The gate on scene 0 at 256x256: B10 alone (intersect_tile)
    on the gate's rays against its plain version, (t, triangle, hit)
    bit-equal, the direct-pixel counts equal and the gate GATE_TRIS.  Then
    recover100 on all 100 scenes at 256x256/64 spp/16 bounces from the GCN
    of artifacts/exp100/gcn_params.npz (100 renders and B5 extractions at
    500x500/100 spp), 3 steps at lr 1e-2, then the gate and the hybrid;
    and full_pipeline on 4 scenes at 500x500/100 spp (GCN 2000 epochs for
    train and train0, 2 scenes evaluated, recovery of 4 scenes x 5 steps
    at 256x256/64 spp).  Both under no_plain_versions, with the launches of
    B1, B2, B5 and B10 alone counted from 0 and required; finite results
    of the expected shapes, the gate, the recovery's loss lower after its 3
    steps than before; each module's phase seconds."""
    import numpy as np
    import torch

    from inverse_path_tracer_torch import ASSET_ROOT, load_scene
    from inverse_path_tracer_torch.experiments import full_pipeline, gate, recover100
    from inverse_path_tracer_torch.ops.kernels.render_kernel import intersect_tile, \
        intersect_tile_plain

    t_phase = time.perf_counter()
    scene = load_scene(os.path.join(REPO, "scenes", "0.txt"), asset_root=ASSET_ROOT).to(device)
    cfg = gate.gate_config(256)
    p, d = gate.gate_rays(scene, 256)
    t, row = intersect_tile(scene, cfg, p, d)
    t_p, row_p = intersect_tile_plain(scene, cfg, p, d)
    hit, hit_p = torch.isfinite(t), torch.isfinite(t_p)
    same = torch.equal(t, t_p) and torch.equal(row, row_p) and torch.equal(hit, hit_p)
    plain_px = torch.bincount(row_p[hit_p].long(), minlength=scene.n_tri).cpu().numpy()
    g, px, thr = gate.compute_gate(scene, 256, device)
    tris = np.nonzero(g)[0].tolist()
    ok = same and np.array_equal(px, plain_px) and tris == GATE_TRIS and thr == 16
    log(f"gate, scene 0 at 256x256: B10 alone against its plain version on {p.shape[1]} rays "
        f"(t, triangle, hit) bit-equal {same}; direct px {px.tolist()} (plain equal "
        f"{np.array_equal(px, plain_px)}), threshold {thr}, gate {tris} -> "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the gate on the card differs from its plain version or the JAX run")

    counters = kernel_counters()
    need = ("render_fwd", "render_bwd_grad", "inverse_grid", "cluster_sweep")

    def drive(label, fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_versions():
            out = fn()
        torch.cuda.synchronize()
        launches = {k: counters[k].launches for k in need}
        log(f"{label}: {time.perf_counter() - t0:.1f} s, launches {launches}")
        return out, launches

    work = os.path.join(OUT_DIR, "recover100")
    if os.path.isdir(work):
        shutil.rmtree(work)
    m, launches = drive("recover100, 100 scenes at 256x256/64 spp, 3 steps", lambda: recover100.main(
        ["--scenes", "100", "--res", "256", "--spp", "64", "--steps", "3", "--lr", "1e-2",
         "--init", "gcn", "--workdir", work]))
    refined = np.load(os.path.join(work, "recovered.npy"))
    gated = np.load(os.path.join(work, "recovered_gated.npy"))
    log(f"recover100 seconds: targets {m['targets_wall_s']}, GCN graphs "
        f"{m['gcn_graphs_wall_s']}, recovery {m['recover_wall_s']}, re-renders "
        f"{m['rerender_wall_s']}; GCN init Kd error {m['gcn_init_err']:.5f} (cube "
        f"{m['gcn_init_err_cube']:.5f}), after 3 steps {m['mean_kd_err']:.5f}, gated "
        f"{m['gated_mean_kd_err']:.5f} (cube {m['gated_mean_kd_err_cube']:.5f}); gate "
        f"{m['observability_gate_tris']}")
    with open(os.path.join(work, "losses.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    log(f"recover100 losses {', '.join(f'{v:.6f}' for v in losses)}")
    ok = (refined.shape == gated.shape == (100, 30, 3) and np.isfinite(refined).all()
          and np.isfinite(gated).all() and m["observability_gate_tris"] == GATE_TRIS
          and len(losses) == 3 and losses[-1] < losses[0]
          and all(math.isfinite(m[k]) for k in ("gcn_init_err", "mean_kd_err",
                                                "gated_mean_kd_err", "final_loss")))
    if not ok or not all(launches[k] for k in need):
        raise AssertionError(f"recover100 on the card failed its checks: {launches}")

    work = os.path.join(OUT_DIR, "full_pipeline")
    if os.path.isdir(work):
        shutil.rmtree(work)
    m, launches = drive("full_pipeline, 4 scenes at 500x500/100 spp", lambda: full_pipeline.main(
        ["--n", "4", "--gcn-epochs", "2000", "--eval-scenes", "2", "--recover-n", "4",
         "--recover-steps", "5", "--workdir", work]))
    log("full_pipeline seconds: " + ", ".join(f"{ph} {m[ph]['wall_s']}"
                                              for ph in full_pipeline.PHASES)
        + f"; train Kd error {m['train']['mean_kd_err']}, train0 {m['train0']['kd_err']} "
          f"(PSNR {m['train0']['psnr_true_vs_pred']} dB), evaluate PSNR "
          f"{m['evaluate']['psnr_true_vs_pred']}, recover Kd error {m['recover']['mean_kd_err']}")
    figures = [m["train"]["mean_kd_err"], m["train0"]["kd_err"], m["recover"]["mean_kd_err"],
               m["train0"]["psnr_true_vs_pred"], *m["evaluate"]["psnr_true_vs_pred"]]
    ok = all(math.isfinite(v) for v in figures) and len(m["evaluate"]["psnr_true_vs_pred"]) == 2
    if not ok or not all(launches[k] for k in need[:3]):
        raise AssertionError(f"full_pipeline on the card failed its checks: {launches}")
    log(f"phase 26: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "inverse_path_tracer_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    from inverse_path_tracer_torch.ops.kernels import build

    t0 = time.perf_counter()
    built = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(built) or 'cached'})")
    for name, text in build.build_log.items():
        for kernel, regs, st, ld, stack in ptxas_report(text):
            log(f"  ptxas {name} {kernel}: {regs} registers, spill stores {st} B, spill loads "
                f"{ld} B, stack {stack} B")
            if st or ld:  # no kernel may spill
                raise AssertionError(f"ptxas spills in {kernel}: {st} B stored, {ld} B loaded")

    check_err = check_kernel_vs_plain(device)
    launches = {"render_fwd": main_path(device)}
    golden(device)
    fb_launches, grad = fwd_bwd_path(device)
    launches["render_bwd_grad"] = fb_launches["render_bwd_grad"]
    launches.update(loss_and_grad_path(device, grad))
    fd_gate(device)
    recovery(device)
    kernels = kernel_timing(device, launches, check_err)
    check_err.update(check_inverse_vs_plain(device))
    launches["inverse_grid"], graph, target = extraction_main_path(device)
    b6_launches, large = large_scene_extraction(device)
    launches.update(b6_launches)
    gcn_pipeline(device, graph, target)
    kernels += inverse_kernel_timing(device, launches, check_err, target, large)
    check_err.update(check_staged_vs_plain(device))
    check_l1_branch(device)
    for name, e in check_clustered_vs_dense(device).items():
        check_err[name] = max(check_err[name], e)
    staged_launches, large_vn = large_main_path(device)
    launches.update(staged_launches)
    fd_gate(device, large_vn, large_vn.diffuse, label="large scene (staged)")
    large_target = large_vn_extraction(device, large_vn)
    kernels += large_kernel_timing(device, launches, check_err, large_target)
    kernels.append(reorder_phase(device))
    batched_recovery(device)
    cli_commands(device)
    bvh_phase(device)
    kernels.append(bvh_route_phase(device))
    sharded_phase(device)
    experiments_phase(device)
    for k in kernels:  # the later checks of B1-B6 (clustered tables) count too
        k["max_abs_err"] = max(float(k["max_abs_err"]), check_err.get(k["name"], 0.0))
    for k in kernels:
        if not all(math.isfinite(float(k[f])) for f in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite timing {k}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--shard-worker":
        shard_worker(json.loads(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())

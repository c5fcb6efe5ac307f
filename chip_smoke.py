#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inverse_path_tracer_torch) on one GPU.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits nonzero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources here (render_fwd.cu: B1, B3,
     B7, B8 and B10's own launch; render_bwd.cu: B2, B4 and B9; inverse.cu:
     B5 and B6's two sinks; every kernel sweeps through B10 in
     render_common.cuh), one
     nvcc per source, in parallel;
  3. each kernel against its plain PyTorch version on the card, on the
     scene-0 fixture at 64x64/4 spp/8 bounces: external uniforms with quirks
     on and off, the fused RNG, a specular (Ks > 0) variant and a small
     vertex-normal mesh (242 triangles: clustered, then again with the
     dense sweep, CLUSTER_MIN_TP raised).  Radiance and records rtol 1e-4 / atol 1e-5 and
     equal ray counts; B3's radiance and counts equal B1's; gradients rtol
     1e-4 with an absolute floor of 1e-6 of the largest entry (the kernels
     and the plain one-hot contraction sum in different orders); the
     vertex-normal scene under the knife-edge bounds of the JAX tests;
  4. the forward main path, render_samples on scene 0 at 512x512, 64 spp,
     16 bounces (the bench configuration), fused RNG: launch counts, then
     one warm-up and 3 runs timed with CUDA events, rays/s with rays =
     segments + shadow rays;
  5. the golden gate: scene 0 at 500x500/100 spp/16 bounces with the
     reference cube Kd against artifacts/bench_golden_0.png (mean |d| <
     5/255, p99 < 25/255);
  6. the fwd+bwd main path: the same configuration, loss =
     tonemap_mean(vals, spp).mean() (bench.py:148-151), loss.backward()
     through B1 and B2: launch counts, a finite nonzero gradient, 1 warm-up
     and 3 timed runs, rays/s, a profile;
  7. loss_and_grad_range (B3 + B4) on the same configuration with a
     per-launch loss that sums to the loss above: its gradient equals
     autograd's (rtol 1e-5); timed;
  8. the finite-difference gate of bench.py:196-236: 64x64/16 spp/8
     bounces, fused RNG, eps 2e-2 along the gradient: ratio in (0.98,
     1.02); a random direction's ratio is printed;
  9. recovery: recover_materials on scene 0 at 64x64/8 spp/8 bounces, 30
     Adam steps at lr 0.1 against a render at the true Kd with another key:
     last loss < 0.75 x first and Kd error < 0.7 x the start's
     (tests/test_utils.py:66-71); ms per step; then 3 steps, a checkpoint
     and a resume to 6, bit-equal to 6 uninterrupted steps;
 10. per-kernel timing at the main path's launch shape beside its bound and
     its plain version; there B3's whole record array against its plain
     version (the slots past each ray's last bounce exactly 0 in both), B3's
     radiance and counts equal to B1's, B2 bit-equal across two calls, and
     the persistent grids of B2 and B3;
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
     another order), with B5's float32 grid's reading at that measure;
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
     (the plain stages start from the kernel's carries); B9 on B8's records
     within the gradient tolerance; staged against mega on the card, bit
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
 21. B7, B8 (stages 0 to 3, with the live-lane count) and B9 at the first
     2^20-ray launch of the large render, each against its plain version
     there and timed beside its bound (bounds count the pairs and box tests
     the plain version's sweeps did); B10 as B1 on that launch with
     clustered tables at the auto
     width and at JAX's 768 against dense tables, with the (ray, group) and
     (ray, cluster) box tests and the shares that entered; clustered B2, B3
     on that launch and clustered B6 (both sinks) on the first launch of the
     large extraction, timed; ptxas's registers and spills of the clustered
     kernels.

The kernels' JSON object, then the card's name and power limit, then, last,
{"ok": true, "device": {...}}.  Needs CUDA; exits nonzero without it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
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
        b4_ok = grad_close(d4, d4p) and b4_is_b2
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
        log(f"check {name} ({'dense' if perm is None else 'clustered'}): max |kernel - plain| "
            f"B1 {errs['render_fwd']:.3e}, B3 records "
            f"{errs['render_fwd_rec']:.3e}, B2 {errs['render_bwd_grad']:.3e}, B4 "
            f"{errs['render_bwd_reverse']:.3e}; segments {seg_k:.0f} vs {seg_p:.0f}, {detail}, "
            f"B3 = B1 {same}, B4 = B2 within 1e-5 {b4_is_b2} (bit-equal {torch.equal(d4, dk)})"
            f" -> {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"a kernel disagrees with its plain version on {name}")
    return worst


def main_path(device):
    """Phase 4: the bench configuration through render_samples."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, render_samples
    from inverse_path_tracer_torch.ops.kernels.render_kernel import render_tile
    from inverse_path_tracer_torch.render.forward import camera_rays

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

    def rays_only():
        for lo in range(0, cfg.n_samples, cfg.tile_size):
            idx = torch.arange(lo, min(lo + cfg.tile_size, cfg.n_samples), device=device)
            camera_rays(scene, cfg, 7, idx)

    log(f"camera rays alone: {cuda_ms(rays_only, 3):.3f} ms per render")
    profile_once("one render", lambda: render_samples(mats, scene, 7, cfg, device=device))
    return launches


def profile_once(what, fn, ops=()):
    """Device time by kernel from torch.profiler over one call of fn:
    logged, and returned as {kernel: (ms, launches)} ({} when the profiler
    recorded no device time).  With `ops`, the calls of each named CPU op
    are logged too and returned beside: (kernels, {op: calls})."""
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
    profile_once("one fwd+bwd", lambda: fwd_bwd(7))
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
    profile_once("one loss_and_grad_range", lambda: run(7),
                 ops=("cudaLaunchKernel", "cudaMemsetAsync", "cudaMalloc", "cudaFree",
                      "cudaStreamSynchronize", "aten::_local_scalar_dense"))
    return launches


def fd_gate(device, scene=None, mats=None, label="scene 0"):
    """Phases 8 and 19: central finite differences along the gradient
    (bench.py:196-236): ratio = <g, v> / FD_v in (0.98, 1.02), on scene 0
    or the given scene."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, render_samples
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    cfg = RenderConfig(**FD)
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
    profile_once("one extraction", lambda: run(0))

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
    kernels, calls = profile_once(f"one {label} extraction", run, ops=("aten::nonzero",))
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
    a = tile_inputs(scene, cfg, 0, n, device, external=False)
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(5)).to(device)
    nt = scene.n_tri
    rk, sk = render_tile(mats, scene, cfg, **a)
    rp, sp = render_tile_plain(mats, scene, cfg, **a)
    rr, sr, rec = render_tile_rec(mats, scene, cfg, **a)
    _, _, rec_p = render_tile_rec_plain(mats, scene, cfg, **a)
    dk = grad_tile(mats, scene, cfg, g=g, **a)
    dp = grad_tile_plain(mats, scene, cfg, g=g, **a)
    d4 = reverse_tile(nt, cfg, rec, g)
    d4p = reverse_tile_plain(nt, cfg, rec, g)
    dk2 = grad_tile(mats, scene, cfg, g=g, **a)  # B2 again: the same sums in the same order
    torch.cuda.synchronize()
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
          and torch.equal(rr, rk) and torch.equal(sr, sk)
          and torch.allclose(rec, rec_p, rtol=1e-4, atol=1e-5) and zeros_ok
          and grad_close(dk, dp) and grad_close(d4, d4p) and b2_repeat)
    log(f"full shape (3, {n}): max |kernel - plain| " +
        ", ".join(f"{k} {e:.3e}" for k, e in err.items()) +
        f"; B3 radiance and counts = B1 {torch.equal(rr, rk) and torch.equal(sr, sk)}, B3 "
        f"records within rtol 1e-4 / atol 1e-5 of plain over the whole array, "
        f"{int(past.sum())} unreached slots exactly 0 {zeros_ok}; B2 twice bit-equal "
        f"{b2_repeat}; persistent grids: B2 {grad_tile.blocks} blocks, B3 "
        f"{render_tile_rec.blocks} blocks of 256 -> {'OK' if ok else 'FAIL'}")
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
    # with emitters is the shadow-ray count: segments + shadow rays sweeps
    # (B1 also sweeps the next ray of a segment that roulette ends, which
    # B2 and B3 skip).  Each (ray,
    # triangle) pair needs the face-plane test; the edge-plane tests run only
    # for candidates, which the run does not count, so they are left out and
    # the bound is a floor (the full four-plane test on every pair is printed
    # beside it).  The recursion adds RECURSION_OPS per reached bounce
    # (segment).  Bytes: each input read once, each output written once: p,
    # d, alive, orig in and radiance, stats out (B1); plus the whole record
    # array out (B3); p, d, alive, orig, g in (B2); for B4 the records of the
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
        "render_fwd": bound(t_sweep, f_bytes(n * (3 + 3 + 1 + 1 + 3 + 2) * 4)),
        "render_fwd_rec": bound(t_sweep, f_bytes(n * (3 + 3 + 1 + 1 + 3 + 2) * 4 + rec_bytes)),
        "render_bwd_grad": bound(t_sweep + t_rec, f_bytes(n * (3 + 3 + 1 + 1 + 3) * 4 + out_bytes)),
        "render_bwd_reverse": bound(t_rec, f_bytes(segments * 16 * 4 + stopped_early * 2 * 4
                                                   + n * 3 * 4 + out_bytes)),
    }
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
    `scene` (fused RNG, the camera under rng.CAMERA_STREAM): the rays, the
    pixel colours (3, n) and the packed tables, as the extraction passes
    them."""
    from inverse_path_tracer_torch.ops import rng
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
    from inverse_path_tracer_torch.render.forward import _launches

    _, _, a = next(_launches(scene, cfg, key, 0, cfg.n_samples, None,
                             camera_key=rng.fold_in(key, rng.CAMERA_STREAM)))
    pix_idx = (a["orig"][0].long() // cfg.spp).clamp(0, cfg.width * cfg.height - 1)
    pix = target.reshape(-1, 3)[pix_idx].T.contiguous()
    return a, pix, pack_tables(scene, scene.diffuse)


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
    a0, pix0, tab0 = first_extraction_launch(scene0, cfg, target0)
    a6, pix6, _ = first_extraction_launch(scene_vn, cfg, target_vn)
    tab6 = pack_tables(scene_vn, scene_vn.diffuse, cfg)
    n = a0["p"].shape[1]

    grid, st = inverse_tile(scene0, cfg, pix=pix0, tables=tab0, **a0)
    grid_p, st_p = inverse_tile_plain(scene0, cfg, pix=pix0, **a0)
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
    acc, st_g = inverse_tile_global(scene_vn, cfg, pix=pix6, tables=tab6, **a6)
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
        "inverse_grid": (lambda: inverse_tile(scene0, cfg, pix=pix0, tables=tab0, **a0),
                         lambda: inverse_tile_plain(scene0, cfg, pix=pix0, **a0)),
        "inverse_rec": (lambda: inverse_tile_rec(scene_vn, cfg, tables=tab6, **a6),
                        lambda: inverse_tile_rec_plain(scene_vn, cfg, **a6)),
        "inverse_global": (lambda: inverse_tile_global(scene_vn, cfg, pix=pix6, tables=tab6,
                                                       acc=acc, **a6),
                           lambda: inverse_tile_plain(scene_vn, cfg, pix=pix6, kernel_order=True,
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
    # large_kernel_timing).  Bytes: p, d, alive, orig (and pix for B5 and
    # the global sink) in, the tables in, the counts (2, n) out, and B5's
    # grid, the records sink's whole record array, or the global sink's
    # float64 adds (9 per edge, before the warp sums them) out.
    f_bytes = lambda nbytes: nbytes / PEAK_BYTES * 1e3
    kernels = []
    for k, scene, stats, tab, out_bytes, pix_rows in (
            ("inverse_grid", scene0, st, tab0, grid.numel() * 4, 3),
            ("inverse_rec", scene_vn, st6, tab6, rec.numel() * 4, 0),
            ("inverse_global", scene_vn, st_g, tab6, edges * N_QUANT_BYTES, 3)):
        nt = scene.n_tri
        segments, shadows = float(stats[0].sum()), float(stats[1].sum())
        pairs, boxes = (segments + shadows) * nt, 0
        if tab.cluster_k:
            pairs, boxes = c6["pairs"], c6["group_tests"] + c6["tests"]
        t_sweep = (pairs * FACE_PLANE_OPS + boxes * BOX_OPS) / PEAK_F32_OPS * 1e3
        tab_bytes = sum(t.numel() * 4 for t in (tab.planes, tab.table, tab.vtab, tab.etab, tab.cdf)
                        if t is not None)
        b_ms, b_by = bound(t_sweep, f_bytes(n * (3 + 3 + 1 + 1 + pix_rows + 2) * 4 + tab_bytes
                                            + out_bytes))
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
                dm_p, suf_p = stage_reverse_tile_plain(scene.n_tri, cfg, k, rec, g, suf)
                b9 = (vn_grad_close(dm, dm_p) if vn else grad_close(dm, dm_p)) and bool(
                    torch.allclose(suf_o, suf_p, rtol=1e-5, atol=1e-6))
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
    prof = profile_once("one large staged render", lambda: render(7))
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
    profile_once("one large fwd+bwd", lambda: fwd_bwd(7))

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


def clustered_ptxas():
    """ptxas's report of the clustered kernels (the instantiations whose
    last template argument, kClustered, is true): [(library, kernel,
    registers, spill store bytes, spill load bytes)]."""
    from inverse_path_tracer_torch.ops.kernels import build

    return [(lib, kernel, regs, st, ld)
            for lib, text in build.build_log.items()
            for kernel, regs, st, ld, _ in ptxas_report(text) if kernel.endswith("true>")]


def large_kernel_timing(device, launches, check_err, large_target):
    """Phase 21: B7, B8 (stages 0 to 3) and B9 at the first 2^20-ray launch
    of the large render (the vertex-normal scene, fused RNG), each against
    its plain version there (at least 97% of lanes agreeing) and timed
    beside its bound, B8 with the live-lane count as the staged
    orchestration passes it; B10 as B1 on that launch with clustered tables
    at the auto width and at JAX's 768 and with dense tables, with the box
    tests and the shares that entered; clustered B2 and B3 on that launch
    and clustered B6 (both sinks) on the first launch of the large
    extraction (phase 20, `large_target` its target), timed; ptxas's
    registers and spills of the clustered kernels."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, large_scene
    from inverse_path_tracer_torch.ops.intersect import counting_sweeps
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        inverse_tile_global,
        inverse_tile_rec,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        CAR_ALIVE,
        grad_tile,
        pack_tables,
        render_tile,
        render_tile_plain,
        render_tile_rec,
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
    a = tile_inputs(scene, cfg, 0, n, device, external=False)
    keys = a["keys"]
    tabs = pack_tables(scene, mats, cfg)
    jax_width = cfg.with_(cluster_k=768)
    tabs768 = pack_tables(scene, mats, jax_width)
    dense = pack_tables(scene, mats)
    bins = _scene_bins(scene, cfg)
    nt = scene.n_tri

    carry0 = init_tile(mats, scene, cfg, a["p"], a["d"], a["alive"], tables=tabs)
    with counting_sweeps() as c_init:
        carry0_p = init_tile_plain(mats, scene, cfg, a["p"], a["d"], a["alive"])
    inputs, counts, agree = {}, {}, {"init_tile": lanes_equal(carry0, carry0_p, True)}
    carry, orig = carry0, a["orig"]
    for s in range(n_stages):
        order = _binned_order(carry, *bins, cfg.bin_cells)
        carry, orig = carry[:, order].contiguous(), orig[:, order].contiguous()
        live = (carry[CAR_ALIVE] > 0).sum(dtype=torch.int32).reshape(1)
        inputs[s] = (carry, orig, live)
        out = stage_tile(mats, scene, cfg, carry, orig, s * k, k, keys=keys, tables=tabs,
                         live=live)
        with counting_sweeps() as c:
            out_p = stage_tile_plain(mats, scene, cfg, carry, orig, s * k, k, keys=keys)
        counts[s] = dict(c)
        agree[f"stage_tile {s}"] = lanes_equal(out, out_p, True)
        carry = out
    c0, o0, live0 = inputs[0]
    _, rec0 = stage_tile(mats, scene, cfg, c0, o0, 0, k, keys=keys, with_rec=True, tables=tabs,
                         live=live0)
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(5)).to(device)
    suf = torch.zeros((4, n), device=device)
    dm, suf_o = stage_reverse_tile(nt, cfg, k, rec0, g, suf)
    dm_p, suf_p = stage_reverse_tile_plain(nt, cfg, k, rec0, g, suf)
    b9_ok = grad_close(dm, dm_p) and bool(torch.allclose(suf_o, suf_p, rtol=1e-5, atol=1e-6))
    rb, sb = render_tile(mats, scene, cfg, tables=tabs, **a)
    rj, sj = render_tile(mats, scene, jax_width, tables=tabs768, **a)
    rd, sd = render_tile(mats, scene, cfg, tables=dense, **a)
    with counting_sweeps() as c_b1:
        rp, sp = render_tile_plain(mats, scene, cfg, **a)
    with counting_sweeps() as c_768:
        render_tile_plain(mats, scene, jax_width, **a)
    torch.cuda.synchronize()
    agree["cluster_sweep (B1)"] = lanes_equal(rb, rp, True)
    agree["B1 at 768"] = lanes_equal(rj, rb, True)
    agree["dense B1"] = lanes_equal(rd, rb, True)
    ok = all(f >= 0.97 for f, _ in agree.values()) and b9_ok
    log(f"large launch (3, {n}), clusters of {tabs.cluster_k}: " + ", ".join(
        f"{key} {f:.5f} lanes agree (max |d| {e:.3e})" for key, (f, e) in agree.items())
        + f"; stage_reverse_tile within tolerance {b9_ok} (max |d| "
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
        "init_tile": (lambda: init_tile(mats, scene, cfg, a["p"], a["d"], a["alive"],
                                        tables=tabs),
                      lambda: init_tile_plain(mats, scene, cfg, a["p"], a["d"], a["alive"])),
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
    # sweeps of the plain version did, the same tests as the kernel's (the
    # hot cluster for every ray it sweeps, a group or cluster box where the
    # ray reached it, the clusters that the ray enters before its closest
    # hit): the (ray, triangle) pairs at FACE_PLANE_OPS each and the (ray,
    # box) tests at BOX_OPS each, over the f32 peak (a floor, as in phase
    # 10); the dense B1 sweeps every triangle.  B9: RECURSION_OPS per
    # reached slot.  Bytes: each input read once, each output written once:
    # rays (7 floats) in and the carry (24) out for B7; the carry in and out
    # and orig for B8; for B9 the reached records, a flag pair where a lane
    # stopped before the stage's last slot, g, the carry in and out and d
    # materials.
    def f_ops(c):
        work = c["pairs"] * FACE_PLANE_OPS + (c["group_tests"] + c["tests"]) * BOX_OPS
        return work / PEAK_F32_OPS * 1e3

    f_bytes = lambda nbytes: nbytes / PEAK_BYTES * 1e3
    rr = rec0.view(k, 16, -1)
    reached = ((rr[:, 14] + rr[:, 15]) > 0)
    n_reached = float(reached.sum())
    stopped = float((reached.sum(dim=0) < k).sum())
    primaries, shadows = float(a["alive"].sum()), float(sd[1].sum())
    dense_pairs = (primaries + 2 * shadows) * nt
    ray_bytes = f_bytes(n * (3 + 3 + 1 + 1 + 3 + 2) * 4)
    bounds = {
        "init_tile": bound(f_ops(c_init), f_bytes(n * (7 + 24) * 4)),
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
    for what, c in (("B1 clustered", c_b1), ("B1 at 768", c_768), ("B7", c_init),
                    *((f"B8 stage {s}", counts[s]) for s in range(n_stages))):
        log(f"large launch (3, {n}) sweep work, {what}: {c['pairs']:.0f} (ray, triangle) pairs, "
            f"(ray, group) box tests {c['group_tests']} of which {c['group_entered']} entered "
            f"({100 * c['group_entered'] / max(c['group_tests'], 1):.2f}%), (ray, cluster) box "
            f"tests {c['tests']} of which {c['entered']} entered "
            f"({100 * c['entered'] / max(c['tests'], 1):.2f}%)")
    log(f"large launch (3, {n}): dense sweeps {dense_pairs:.0f} pairs; B9 reached slots "
        f"{n_reached:.0f}")
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
    a6, pix6, _ = first_extraction_launch(scene, golden_cfg, large_target)
    tab6 = pack_tables(scene, mats, golden_cfg)
    acc6 = torch.zeros((nt + 1, nt, 9), dtype=torch.float64, device=device)
    more = {
        "render_bwd_grad (B2) clustered": lambda: grad_tile(mats, scene, cfg, g=g3, tables=tabs,
                                                            **a),
        "render_fwd_rec (B3) clustered": lambda: render_tile_rec(mats, scene, cfg, tables=tabs,
                                                                 **a),
        "inverse_rec (B6 records) clustered, extraction launch": lambda: inverse_tile_rec(
            scene, golden_cfg, tables=tab6, **a6),
        "inverse_global (B6 global grid) clustered, extraction launch": lambda: (
            inverse_tile_global(scene, golden_cfg, pix=pix6, tables=tab6, acc=acc6, **a6)),
    }
    for what, fn in more.items():
        fn()  # warm-up
        log(f"{what} at (3, {n}): {cuda_ms(fn, 3):.4f} ms (clusters of {tabs.cluster_k})")

    report = clustered_ptxas()
    for lib, kernel, regs, st, ld in report:
        log(f"  ptxas {lib} {kernel}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    b8_b1 = [(st, ld) for _, kernel, _, st, ld in report
             if kernel.startswith(("stage_kernel", "render_fwd_kernel<"))]
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
    sys.exit(main())

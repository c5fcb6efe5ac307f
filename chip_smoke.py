#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inverse_path_tracer_torch) on one GPU.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits nonzero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the forward path from the sources here;
  3. each kernel against its plain PyTorch version on the card, on the
     scene-0 fixture at 64x64/4 spp/8 bounces: external uniforms with quirks
     on and off, the fused RNG, a specular (Ks > 0) variant and a small
     vertex-normal mesh (rtol 1e-4, atol 1e-5, equal ray counts; the
     vertex-normal scene under the knife-edge bound of the JAX tests);
  4. the main path, render_samples on scene 0 at 512x512, 64 spp, 16
     bounces (the bench configuration), fused RNG: launch counts, then one
     warm-up and 3 runs timed with CUDA events, rays/s with rays = segments
     + shadow rays;
  5. the golden gate: scene 0 at 500x500/100 spp/16 bounces with the
     reference cube Kd against artifacts/bench_golden_0.png (mean |d| <
     5/255, p99 < 25/255);
  6. per-kernel timing at the main path's launch shape beside its bound.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.  Needs CUDA; exits nonzero without it.
"""

from __future__ import annotations

import json
import math
import os
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

CHECK = dict(width=64, height=64, spp=4, max_bounces=8)
MAIN = dict(width=512, height=512, spp=64, max_bounces=16)
GOLDEN = dict(width=500, height=500, spp=100, max_bounces=16)
GOLDEN_PNG = os.path.join(REPO, "artifacts", "bench_golden_0.png")


def log(*a):
    print(*a, flush=True)


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


def check_kernel_vs_plain(device):
    """Phase 3: render_tile (kernel) against render_tile_plain on the card."""
    import torch

    from inverse_path_tracer_torch import RenderConfig
    from inverse_path_tracer_torch.ops.kernels.render_kernel import render_tile, render_tile_plain

    cfg0 = RenderConfig(**CHECK)
    scene0, mats0 = fixture(device)
    cases = [
        ("external_quirks", scene0, mats0, cfg0, True),
        ("external_no_quirks", scene0, mats0, cfg0.with_(reference_quirks=False), True),
        ("fused", scene0, mats0, cfg0, False),
    ]
    cases += [(name, s, m, cfg0, False) for name, s, m in variant_scenes(device)]
    worst = 0.0
    for name, scene, mats, cfg, external in cases:
        a = tile_inputs(scene, cfg, 11, cfg.n_samples, device, external)
        rk, sk = render_tile(mats, scene, cfg, **a)
        rp, sp = render_tile_plain(mats, scene, cfg, **a)
        torch.cuda.synchronize()
        if not (torch.isfinite(rk).all() and torch.isfinite(rp).all()):
            raise AssertionError(f"{name}: non-finite radiance")
        err = float((rk - rp).abs().max())
        seg_k, seg_p = float(sk[0].sum()), float(sp[0].sum())
        if name == "vertex_normals":
            # Knife-edge bound (tests/test_pallas.py:219-223): grazing hits on
            # curved geometry may resolve differently within an ulp.
            close = torch.isclose(rk, rp, rtol=1e-4, atol=1e-5).all(dim=0).float().mean()
            mean_d = float((rk - rp).abs().mean())
            ok = close >= 0.97 and mean_d < 0.02 and abs(seg_k - seg_p) <= 1e-3 * seg_p + 8
            detail = f"close lanes {float(close):.5f}, mean |d| {mean_d:.3e}"
        else:
            ok = torch.allclose(rk, rp, rtol=1e-4, atol=1e-5) and torch.equal(sk, sp)
            detail = f"counts equal {torch.equal(sk, sp)}"
            worst = max(worst, err)
        log(f"check {name}: max |kernel - plain| {err:.3e}, segments {seg_k:.0f} vs "
            f"{seg_p:.0f}, {detail} -> {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version on {name}")
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
    log(f"main path 512x512/64spp/16b: {launches} launches of render_fwd, "
        f"segments {int(stats.segments)}, shadow rays {int(stats.shadow_rays)}, "
        f"mean radiance {mean:.5f}")
    render_samples(mats, scene, 1, cfg, device=device)  # warm-up
    for k in range(3):
        out = []
        t = cuda_ms(lambda: out.append(render_samples(mats, scene, k + 2, cfg, device=device)), 1)
        st = out[0][1]
        rays = int(st.segments) + int(st.shadow_rays)
        log(f"main path run {k}: {t:.3f} ms, rays {rays}, {rays / (t / 1e3):.6e} rays/s")
    breakdown(mats, scene, cfg, device)
    return launches


def breakdown(mats, scene, cfg, device):
    """Where the main path's time goes: the camera rays alone (CUDA events),
    and device time by kernel from torch.profiler over one render."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from inverse_path_tracer_torch import render_samples
    from inverse_path_tracer_torch.render.forward import camera_rays

    def rays_only():
        for lo in range(0, cfg.n_samples, cfg.tile_size):
            idx = torch.arange(lo, min(lo + cfg.tile_size, cfg.n_samples), device=device)
            camera_rays(scene, cfg, 7, idx)

    log(f"camera rays alone: {cuda_ms(rays_only, 3):.3f} ms per render")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_samples(mats, scene, 7, cfg, device=device)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {
        e.key: (getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    }
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        log("profile: the profiler recorded no device time (device busy share not measured)")
        return
    log(f"profile (one render, profiler on): wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
    for name, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms:10.3f} ms  x{count:<5d} {name[:100]}")


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


def kernel_timing(device, launches):
    """Phase 6: render_fwd at the main path's launch shape (the first
    cfg.tile_size samples of the bench render) beside its plain version and
    its bound."""
    import torch

    from inverse_path_tracer_torch import RenderConfig
    from inverse_path_tracer_torch.ops.kernels.render_kernel import render_tile, render_tile_plain

    cfg = RenderConfig(**MAIN)
    scene, mats = fixture(device)
    n = min(cfg.tile_size, cfg.n_samples)
    a = tile_inputs(scene, cfg, 0, n, device, external=False)
    rk, sk = render_tile(mats, scene, cfg, **a)
    rp, sp = render_tile_plain(mats, scene, cfg, **a)
    torch.cuda.synchronize()
    err = float((rk - rp).abs().max())
    if not (torch.allclose(rk, rp, rtol=1e-4, atol=1e-5) and torch.equal(sk, sp)):
        raise AssertionError(f"render_fwd disagrees with its plain version at full shape ({err})")
    ms = cuda_ms(lambda: render_tile(mats, scene, cfg, **a), 20)
    plain_ms = cuda_ms(lambda: render_tile_plain(mats, scene, cfg, **a), 2)
    # Bound: the closest-hit sweeps this launch's rays needed, over the f32
    # peak.  A live primary ray is swept once before the loop; every segment
    # that hits sweeps twice (shadow ray and next ray, both before roulette),
    # and on a scene with emitters the hit segments are the shadow-ray count;
    # escaping segments sweep nothing.  Each (ray, triangle) pair needs the
    # face-plane test; the edge-plane tests run only for candidates, which
    # the run does not count, so they are left out and the bound is a floor.
    # The full four-plane test on every pair is printed beside it.  Bytes: p,
    # d, alive, orig in; radiance, stats out.
    if scene.n_emissive == 0:
        raise AssertionError("the bound counts hit segments by shadow rays")
    primaries, shadows = float(a["alive"].sum()), float(sk[1].sum())
    pairs = (primaries + 2 * shadows) * scene.n_tri
    t_ops = pairs * FACE_PLANE_OPS / PEAK_F32_OPS * 1e3
    t_full = pairs * (FACE_PLANE_OPS + 3 * EDGE_PLANE_OPS) / PEAK_F32_OPS * 1e3
    t_bytes = n * (3 + 3 + 1 + 1 + 3 + 2) * 4 / PEAK_BYTES * 1e3
    log(f"render_fwd at (3, {n}): {ms:.4f} ms (plain {plain_ms:.3f} ms), "
        f"{float(sk[0].sum()):.0f} segments, {shadows:.0f} shadow rays, {pairs:.0f} "
        f"(ray, triangle) pairs, bound {max(t_ops, t_bytes):.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}: ops {t_ops:.4f}, bytes {t_bytes:.4f}; "
        f"full four-plane test on every pair {t_full:.4f})")
    return {
        "name": "render_fwd",
        "route": "cuda",
        "source": "inverse_path_tracer_torch/ops/kernels/render_fwd.cu",
        "replaces": "inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1440",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    check_err = check_kernel_vs_plain(device)
    launches = main_path(device)
    golden(device)
    k = kernel_timing(device, launches)
    k["max_abs_err"] = max(k["max_abs_err"], check_err)
    if not all(math.isfinite(float(v)) for v in (k["ms"], k["plain_ms"], k["bound_ms"])):
        raise AssertionError(f"non-finite timing {k}")

    print(json.dumps({"kernels": [k]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

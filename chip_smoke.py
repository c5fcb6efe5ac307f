#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inverse_path_tracer_torch) on one GPU.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits nonzero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources here (render_fwd.cu: B1 and
     B3; render_bwd.cu: B2 and B4), one nvcc per source, in parallel;
  3. each kernel against its plain PyTorch version on the card, on the
     scene-0 fixture at 64x64/4 spp/8 bounces: external uniforms with quirks
     on and off, the fused RNG, a specular (Ks > 0) variant and a small
     vertex-normal mesh.  Radiance and records rtol 1e-4 / atol 1e-5 and
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
     (tests/test_utils.py:66-71); ms per step;
 10. per-kernel timing at the main path's launch shape beside its bound and
     its plain version.

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
}
# f32 operations of the suffix recursion per reached bounce (render_bwd.cu
# reverse_path): ct = pm*suf*(coeff/pi) + g*pm*nee (3+3+1+3+3+3), suf =
# g*c + f*suf (9), and the 3 adds of the warp sum into d materials.
RECURSION_OPS = 28
GOLDEN_PNG = os.path.join(REPO, "artifacts", "bench_golden_0.png")


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
    cases += [(name, s, m, cfg0, False) for name, s, m in variant_scenes(device)]
    worst = dict.fromkeys(KERNELS, 0.0)
    for name, scene, mats, cfg, external in cases:
        a = tile_inputs(scene, cfg, 11, cfg.n_samples, device, external)
        g = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(3)).to(device)
        rk, sk = render_tile(mats, scene, cfg, **a)
        rp, sp = render_tile_plain(mats, scene, cfg, **a)
        rr, sr, rec = render_tile_rec(mats, scene, cfg, **a)
        _, _, rec_p = render_tile_rec_plain(mats, scene, cfg, **a)
        dk = grad_tile(mats, scene, cfg, g=g, **a)
        dp = grad_tile_plain(mats, scene, cfg, g=g, **a)
        d4 = reverse_tile(scene.n_tri, cfg, rec, g)
        d4p = reverse_tile_plain(scene.n_tri, cfg, rec, g)
        torch.cuda.synchronize()
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
        if name == "vertex_normals":
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
        log(f"check {name}: max |kernel - plain| B1 {errs['render_fwd']:.3e}, B3 records "
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


def profile_once(what, fn):
    """Device time by kernel from torch.profiler over one call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    log(f"profile ({what}, profiler on): wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
    for name, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms:10.3f} ms  x{count:<5d} {name[:100]}")


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
    profile_once("one loss_and_grad_range", lambda: run(7))
    return launches


def fd_gate(device):
    """Phase 8: central finite differences along the gradient
    (bench.py:196-236): ratio = <g, v> / FD_v in (0.98, 1.02)."""
    import torch

    from inverse_path_tracer_torch import RenderConfig, render_samples
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    cfg = RenderConfig(**FD)
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
    log(f"grad FD gate {shape(cfg)} fused: along g analytic {an:.6e} fd {fd:.6e} ratio "
        f"{r:.5f}; random direction ratio {r_rand:.5f} -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"grad FD ratio {r:.5f} outside (0.98, 1.02)")
    return r, r_rand


def recovery(device):
    """Phase 9: recover_materials on scene 0 against a render at the true Kd
    (tests/test_utils.py:52-71 at 64x64/8 spp/8 bounces)."""
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
    return ms_step


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
    torch.cuda.synchronize()
    err = {"render_fwd": float((rk - rp).abs().max()),
           "render_fwd_rec": float((rec - rec_p).abs().max()),
           "render_bwd_grad": float((dk - dp).abs().max()),
           "render_bwd_reverse": float((d4 - d4p).abs().max())}
    ok = (torch.allclose(rk, rp, rtol=1e-4, atol=1e-5) and torch.equal(sk, sp)
          and torch.equal(rr, rk) and torch.equal(sr, sk)
          and torch.allclose(rec, rec_p, rtol=1e-4, atol=1e-5)
          and grad_close(dk, dp) and grad_close(d4, d4p))
    log(f"full shape (3, {n}): max |kernel - plain| " +
        ", ".join(f"{k} {e:.3e}" for k, e in err.items()) + f" -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version at full shape")
    del rec_p
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
    # rays needed, over the f32 peak.  A live primary ray is swept once before
    # the loop; every segment that hits sweeps twice (shadow ray and next ray,
    # both before roulette), and on a scene with emitters the hit segments
    # are the shadow-ray count; escaping segments sweep nothing.  Each (ray,
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
    primaries, segments, shadows = (float(a["alive"].sum()), float(sk[0].sum()),
                                    float(sk[1].sum()))
    stopped_early = float((sk[0] < cfg.max_bounces).sum())
    pairs = (primaries + 2 * shadows) * nt
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
    for k, (src, replaces) in KERNELS.items():
        b_ms, b_by = bounds[k]
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
    launches = {"render_fwd": main_path(device)}
    golden(device)
    fb_launches, grad = fwd_bwd_path(device)
    launches["render_bwd_grad"] = fb_launches["render_bwd_grad"]
    launches.update(loss_and_grad_path(device, grad))
    fd_gate(device)
    recovery(device)
    kernels = kernel_timing(device, launches, check_err)
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

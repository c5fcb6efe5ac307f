"""Forward render of one image per job: render/forward.py render_samples
(the default route: on clustered scenes the staged wavefront) and the
tonemap, the image synchronised on the device.  Each job renders under its
own key from the seed; the seeded objects' Kd is drawn once from the seed.

The check compares, in a sample of the window's jobs drawn from the seed,
the radiance of `check_runs` runs of `run_pixels` consecutive pixels, one
drawn in each of `check_runs` equal stretches of the image (all their
samples, in global sample order) with the reference's, and the path
segments and shadow rays of those samples (the program's counted by
render_range over each run, outside the timed jobs)."""

from __future__ import annotations

import random

import torch

from benchmark.lib import floors, program
from benchmark.reference import rng as rr
from benchmark.reference import tracer

WARM_TAG = 0xFFFFFFFF


class State:
    pass


def setup(ctx):
    st, t = State(), ctx.traffic
    st.t, st.ctx, st.device = t, ctx, ctx.device
    st.cfg = program.render_config(ctx.config, t)
    st.scene = program.build_scene(ctx.config, ctx.gen_dir).to(ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    st.mats = program.materials(st.scene.diffuse, ctx.config, ctx.gen_dir, gen, 1)[0]
    st.key = program.base_key(ctx.seed)
    rand = random.Random(ctx.seed)
    n_pix, run = t["width"] * t["height"], t["run_pixels"]
    k = t["check_runs"]  # one run in each of k equal stretches of the image
    st.runs = [lo + rand.randrange(max(hi - lo - run, 0) + 1)
               for lo, hi in ((n_pix * j // k, n_pix * (j + 1) // k) for j in range(k))]
    spp = t["spp"]
    st.idx = torch.cat([torch.arange(p * spp, (p + run) * spp) for p in st.runs]).to(ctx.device)
    st.kept = program.Reservoir(t["check_jobs"], ctx.seed)
    st.hits = torch.zeros((), dtype=torch.int64, device=ctx.device)
    for w in range(t.get("warmup_jobs", 1)):
        _render(st, rr.fold_in(st.key, WARM_TAG - w))
    return st


def _render(st, key):
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean
    from inverse_path_tracer_torch.render import forward

    vals, stats = forward.render_samples(st.mats, st.scene, key, st.cfg, device=st.device)
    tonemap_mean(vals, st.cfg.spp)
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    return vals, stats


def paths_per_job(st) -> int:
    return st.cfg.n_samples


def job(st, i):
    return _render(st, rr.fold_in(st.key, i))


def collect(st, i, result):
    vals, stats = result
    st.hits += stats.shadow_rays
    st.kept.offer(lambda: (rr.fold_in(st.key, i), vals[st.idx].detach().cpu()))


def after_window(st):
    """The program's counts over each run of the kept jobs (render_range,
    outside the timed jobs), then its state is freed."""
    from inverse_path_tracer_torch.render import forward

    run, spp = st.t["run_pixels"], st.cfg.spp
    counts = []
    with torch.no_grad():
        for key, _ in st.kept.items:
            c = 0
            for p in st.runs:
                _, s = forward.render_range(st.mats, st.scene, key, st.cfg, p * spp, run * spp,
                                            device=st.device)
                c += int(s.segments) + int(s.shadow_rays)
            counts.append(c)
    st.out = dict(rad=[r for _, r in st.kept.items], counts=counts)
    n_jobs = max(st.kept.seen, 1)
    st.least = dict(hits=int(st.hits) / n_jobs,
                    bytes=st.cfg.n_samples * 12 + st.t["width"] * st.t["height"] * 12
                    + floors.scene_bytes(st.scene.n_tri, st.scene.has_vertex_normals))
    del st.scene


def reference_outputs(st, dt):
    sc = tracer.on(program.reference_scene(st.ctx.config, st.ctx.gen_dir), st.device, dt)
    t, rads, counts = st.t, [], []
    for key, _ in st.kept.items:
        rad, segs, sh = tracer.render(sc, st.mats.to(dt), key, st.idx, t["width"], t["height"],
                                      t["spp"], st.cfg.max_bounces, st.cfg.p_rr)
        rads.append(rad.float().cpu())
        counts.append(int(segs.sum()) + int(sh.sum()))
    return dict(rad=rads, counts=counts)


def judge(st, out, ref):
    p, r = torch.cat(out["rad"]), torch.cat(ref["rad"])
    off = ((p - r).abs() > 1e-4 + 1e-3 * r.abs()).any(dim=1)
    cp, cr = sum(out["counts"]), sum(ref["counts"])
    return {"rad_mismatch": float(off.float().mean()), "count_gap": abs(cp - cr) / max(cr, 1)}

"""Batched material recovery, the system's training workload: one job is
one step of models/recover.py batched_step over S scenes sharing geometry,
keyed as recover_materials_batched keys it (scene j of step i under
fold_in(fold_in(key, i), j)), Adam from make_optimizer, the loss read on
the host each step.  Targets are drawn from the seed on the device; the
step's work does not depend on their values.

Set-up builds theta (S, nT, 3) = 0 and its Adam and drives them through
the first `check_steps` steps, which the window then continues.  The check
holds those steps against the reference's (reference/tracer.py
recover_steps): each step's losses, the first gradient (Adam's first
moment after one step over 1 - b1) and theta's change after the steps,
the last two by the worst scene's norm; and the shadow rays of the first
step's renders."""

from __future__ import annotations

import torch

from benchmark.lib import program
from benchmark.reference import rng as rr
from benchmark.reference import tracer

B1 = 0.9


class State:
    pass


def step_keys(key: int, step: int, scenes: int):
    k = rr.fold_in(key, step)
    return [rr.fold_in(k, j) for j in range(scenes)]


def _step(st, i):
    from inverse_path_tracer_torch.models import recover

    losses = recover.batched_step(st.theta, st.opt, st.scene, step_keys(st.key, i, st.s), st.cfg,
                                  st.targets, st.t["n_keys"], st.t["scene_chunk"],
                                  device=st.device)
    st.last_loss = float(losses.mean())  # the host reads the loss every step
    return losses


def setup(ctx):
    from inverse_path_tracer_torch.models import recover

    st, t = State(), ctx.traffic
    st.t, st.ctx, st.device, st.s = t, ctx, ctx.device, t["scenes"]
    st.cfg = program.render_config(ctx.config, t)
    st.scene = program.build_scene(ctx.config, ctx.gen_dir).to(ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    st.targets = torch.rand((st.s, t["height"], t["width"], 3), generator=gen, device=ctx.device)
    st.key = program.base_key(ctx.seed)
    st.theta = torch.zeros((st.s, st.scene.n_tri, 3), device=ctx.device, requires_grad=True)
    st.opt = recover.make_optimizer(st.theta, t["lr"])
    losses = []
    for i in range(t["check_steps"]):
        losses.append(_step(st, i).detach().double().cpu())
        if i == 0:
            g1 = (st.opt.state[st.theta]["exp_avg"] / (1 - B1)).detach().cpu()
    st.out = dict(losses=losses, g1=g1, theta=st.theta.detach().cpu().clone())
    return st


def paths_per_job(st) -> int:
    return st.s * st.cfg.n_samples


def job(st, i):
    return _step(st, st.t["check_steps"] + i)


def collect(st, i, result):
    pass


def after_window(st):
    """The shadow rays of the first step's renders (outside the timed
    jobs), then the program's state is freed."""
    from inverse_path_tracer_torch.render import forward

    hits = 0
    with torch.no_grad():
        for j, k in enumerate(step_keys(st.key, 0, st.s)):
            _, stats = forward.render_samples(torch.full_like(st.scene.diffuse, 0.5), st.scene,
                                              k, st.cfg, device=st.device)
            hits += int(stats.shadow_rays)
    st.out["hits"] = hits
    st.least = dict(hits=hits, bytes=_job_bytes(st))
    del st.theta, st.opt, st.scene


def _job_bytes(st) -> int:
    """Targets and theta with Adam's two moments read; theta and the
    moments written; the scene read."""
    from benchmark.lib import floors

    n = st.out["theta"].numel()
    return st.targets.numel() * 4 + 3 * n * 4 * 2 + floors.scene_bytes(n // (3 * st.s), False)


def reference_outputs(st, dt):
    sc = tracer.on(program.reference_scene(st.ctx.config, st.ctx.gen_dir), st.device, dt)
    t = st.t
    keys = [step_keys(st.key, i, st.s) for i in range(t["check_steps"])]
    steps, theta = tracer.recover_steps(sc, st.targets, keys, t["lr"], t["width"], t["height"],
                                        t["spp"], st.cfg.max_bounces, st.cfg.p_rr,
                                        t.get("ref_pixels_per_chunk", 1 << 15))
    return dict(losses=[s["losses"].cpu() for s in steps], g1=steps[0]["grads"].float().cpu(),
                theta=theta.float().cpu(), hits=steps[0]["hits"])


def _worst_leaf(p, r):
    """The worst scene's |norm(p_j) - norm(r_j)| over the larger of
    norm(r_j) and the median scene's norm."""
    np_, nr = p.flatten(1).norm(dim=1), r.flatten(1).norm(dim=1)
    scale = torch.maximum(nr, nr.median().expand_as(nr))
    return float(((np_ - nr).abs() / scale).max())


def judge(st, out, ref):
    loss = max(float(((a - b).abs() / b.abs()).max()) for a, b in zip(out["losses"], ref["losses"]))
    return {
        "loss_gap": loss,
        "grad_norm_gap": _worst_leaf(out["g1"], ref["g1"]),
        "change_norm_gap": _worst_leaf(out["theta"], ref["theta"]),
        "hits_gap": abs(out["hits"] - ref["hits"]) / max(ref["hits"], 1),
    }

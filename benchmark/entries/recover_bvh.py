"""The batched recovery of benchmark/entries/recover.py on the BVH route:
RenderConfig(intersect="bvh"), as the configuration's renderer states, on
the program's scene with its tree (ops/bvh.py attach_bvh, built in set-up,
so that setup_s carries it).  A step's forward is then B1's BVH instance
and its backward B2's (render_bwd.cu grad_tile_kernel<..., 2>), one launch
each per 2^20 samples.  The job, the check, the reference, the judge and
the least work are recover.py's; set-up is recover.py's with the route's
config and scene, its check steps run on the route.

Set-up fails the run unless the steps take the route: the configuration
asks for it, the scene carries its tree (clusters.uses_bvh), and on the
card the check steps ran B2 and the traversal (render_kernel's
grad_tile.launches and bvh_traversal.launches grew; on the CPU the plain
versions launch nothing).

The recover entry's faults (benchmark/faults.py) hold here unchanged; they
are registered under this entry's name when the entry is loaded."""

from __future__ import annotations

import dataclasses
import os

import torch

from benchmark import faults
from benchmark.lib import program
from benchmark.lib.manifest import load_module

recover = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "recover.py"),
                      "bench_entry_recover")
faults.BY_ENTRY.setdefault("recover_bvh", faults.BY_ENTRY["recover"])

paths_per_job = recover.paths_per_job
job = recover.job
collect = recover.collect
after_window = recover.after_window
reference_outputs = recover.reference_outputs
judge = recover.judge


def setup(ctx):
    from inverse_path_tracer_torch.models.recover import make_optimizer
    from inverse_path_tracer_torch.ops.bvh import attach_bvh
    from inverse_path_tracer_torch.ops.kernels.clusters import uses_bvh
    from inverse_path_tracer_torch.ops.kernels.render_kernel import bvh_traversal, grad_tile

    intersect = ctx.config["renderer"].get("intersect")
    if intersect != "bvh":
        raise ValueError(f"the recover_bvh entry recovers on the BVH route: the configuration's "
                         f"intersect is {intersect!r}, not 'bvh'")
    st, t = recover.State(), ctx.traffic
    st.t, st.ctx, st.device, st.s = t, ctx, ctx.device, t["scenes"]
    st.cfg = dataclasses.replace(program.render_config(ctx.config, t), intersect=intersect)
    st.scene = attach_bvh(program.build_scene(ctx.config, ctx.gen_dir).to(ctx.device))
    if not uses_bvh(st.scene, st.cfg):
        raise RuntimeError("the scene carries no BVH: the steps would take the sweep route")
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    st.targets = torch.rand((st.s, t["height"], t["width"], 3), generator=gen, device=ctx.device)
    st.key = program.base_key(ctx.seed)
    st.theta = torch.zeros((st.s, st.scene.n_tri, 3), device=ctx.device, requires_grad=True)
    st.opt = make_optimizer(st.theta, t["lr"])
    before = (grad_tile.launches, bvh_traversal.launches)
    losses = []
    for i in range(t["check_steps"]):
        losses.append(recover._step(st, i).detach().double().cpu())
        if i == 0:
            g1 = (st.opt.state[st.theta]["exp_avg"] / (1 - recover.B1)).detach().cpu()
    if st.device.type == "cuda" and (grad_tile.launches == before[0]
                                     or bvh_traversal.launches == before[1]):
        raise RuntimeError("the check steps launched no B2 or no BVH traversal")
    st.out = dict(losses=losses, g1=g1, theta=st.theta.detach().cpu().clone())
    return st

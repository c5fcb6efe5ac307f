"""The forward render of benchmark/entries/render.py on the BVH route:
RenderConfig(intersect="bvh"), as the configuration's renderer states, on
the program's scene with its tree (ops/bvh.py attach_bvh, built in set-up,
so that setup_s carries it).  The job, the check, the reference and the
least work are render.py's.

Set-up fails the run unless the render takes the route: the configuration
asks for it, the scene carries its tree (clusters.uses_bvh), and on the
card the warm-up ran the traversal (render_kernel.bvh_traversal.launches
grew; on the CPU the plain versions launch nothing).

The render entry's faults (benchmark/faults.py) hold here unchanged; they
are registered under this entry's name when the entry is loaded, as
benchmark/control.py loads it before it plants one, and as
benchmark/conftest.py loads every entry before the benchmark's tests."""

from __future__ import annotations

import dataclasses
import os
import types

from benchmark import faults
from benchmark.lib.manifest import load_module
from benchmark.reference import rng as rr

render = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "render.py"),
                     "bench_entry_render")
faults.BY_ENTRY.setdefault("render_bvh", faults.BY_ENTRY["render"])

paths_per_job = render.paths_per_job
job = render.job
collect = render.collect
after_window = render.after_window
reference_outputs = render.reference_outputs
judge = render.judge


def setup(ctx):
    from inverse_path_tracer_torch.ops.bvh import attach_bvh
    from inverse_path_tracer_torch.ops.kernels import render_kernel
    from inverse_path_tracer_torch.ops.kernels.clusters import uses_bvh

    intersect = ctx.config["renderer"].get("intersect")
    if intersect != "bvh":
        raise ValueError(f"the render_bvh entry renders on the BVH route: the configuration's "
                         f"intersect is {intersect!r}, not 'bvh'")
    # render.py's set-up without its warm-up, which has to run on the route.
    st = render.setup(types.SimpleNamespace(**dict(vars(ctx), traffic=dict(ctx.traffic,
                                                                          warmup_jobs=0))))
    st.t = ctx.traffic
    st.cfg = dataclasses.replace(st.cfg, intersect=intersect)
    st.scene = attach_bvh(st.scene)
    if not uses_bvh(st.scene, st.cfg):
        raise RuntimeError("the scene carries no BVH: the render would take the sweep route")
    before = render_kernel.bvh_traversal.launches
    for w in range(max(1, ctx.traffic.get("warmup_jobs", 1))):
        render._render(st, rr.fold_in(st.key, render.WARM_TAG - w))
    if st.device.type == "cuda" and render_kernel.bvh_traversal.launches == before:
        raise RuntimeError("the warm-up render launched no BVH traversal")
    return st

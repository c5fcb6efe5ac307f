"""The benchmark's sphere1298bvh configuration on the port's BVH route
(RenderConfig.intersect="bvh"), on the CPU through the plain versions.
Neither the port nor the benchmark's reference imports JAX here.

  * The configuration's scene, built by the harness through the program's
    loader (benchmark/lib/program.py build_scene) with its tree from
    ops/bvh.py build_bvh, is assets.large_scene(): the same 1298
    triangles, vertices and vertex normals; check_bvh passes.
  * render_range on that scene and route, against the plain reference
    (benchmark/reference/tracer.py render, a sweep over every triangle of
    each object a ray's box test admits) on seeded random Kd, at 3 runs of
    4 pixels x 4 spp of a 500x500 image: the share of samples whose
    radiance is off by more than the render entry's 1e-4 + 1e-3 * abs(ref)
    within the cell's rad_mismatch limit (a knife-edge hit of a smooth
    normal may turn a bounce; none did on three seeds), segments and
    shadow rays equal.
  * The cell's entry (benchmark/entries/render_bvh.py) at a tiny size:
    setup, jobs, after_window, reference_outputs and judge read correct;
    it refuses a configuration off the route and a scene without a tree.
  * The span ipt.prep.bvh: inside ipt.prep.tables in pack_tables and
    inside the plain versions' launches on the route; absent off it.
"""

import copy
import dataclasses
import os
import random
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, load_scene
from inverse_path_tracer_torch.assets import large_scene
from inverse_path_tracer_torch.ops import bvh as pbvh
from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
from inverse_path_tracer_torch.render import forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.lib import manifest, program  # noqa: E402
from benchmark.reference import tracer  # noqa: E402

CELL = "sphere1298bvh.render_bvh"
SEED = 2**31 + 1907
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cell():
    return manifest.Cell(CELL)


@pytest.fixture(scope="module")
def gen_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gen"))


@pytest.fixture(scope="module")
def scene(cell, gen_dir):
    s = program.build_scene(cell.config, gen_dir)
    return s.replace(bvh=pbvh.build_bvh(s))


def test_config_scene_is_the_large_fixture(cell, scene):
    want = large_scene()
    assert scene.n_tri == want.n_tri == cell.config["triangles"] == 1298
    assert scene.has_vertex_normals and int(scene.emissive_idx.numel()) == cell.config["emissive"]
    torch.testing.assert_close(scene.vertices, want.vertices, rtol=0, atol=0)
    torch.testing.assert_close(scene.vertex_normals, want.vertex_normals, rtol=0, atol=0)
    pbvh.check_bvh(scene.bvh, scene.n_tri)


def test_route_matches_the_reference(cell, scene, gen_dir):
    r = cell.config["renderer"]
    w = h = 500
    spp, run = 4, 4
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=r["max_bounces"], p_rr=r["p_rr"],
                       reference_quirks=r["reference_quirks"], rng=r["rng"],
                       intersect=r["intersect"], backend="plain")
    gen = torch.Generator().manual_seed(SEED)
    mats = program.materials(scene.diffuse, cell.config, gen_dir, gen, 1)[0]
    key = program.base_key(SEED)
    rand = random.Random(SEED)
    starts = [rand.randrange(w * h - run) for _ in range(3)]
    rad, count = [], 0
    for p in starts:
        v, st = forward.render_range(mats, scene, key, cfg, p * spp, run * spp, device="cpu")
        rad.append(v)
        count += int(st.segments) + int(st.shadow_rays)
    sc = tracer.on(program.reference_scene(cell.config, gen_dir), CPU, torch.float32)
    idx = torch.cat([torch.arange(p * spp, (p + run) * spp) for p in starts])
    ref, segs, shadows = tracer.render(sc, mats, key, idx, w, h, spp, cfg.max_bounces, cfg.p_rr)
    got = torch.cat(rad)
    off = ((got - ref).abs() > 1e-4 + 1e-3 * ref.abs()).any(dim=1)
    assert float(off.float().mean()) <= cell.limits["rad_mismatch"]
    assert count == int(segs.sum()) + int(shadows.sum())
    assert float(ref.abs().sum()) > 0  # the samples carry light


def _ctx(cell, gen_dir, **overrides):
    """The entry's context, as benchmark/run.py prepare builds it, at a tiny
    size on the CPU (without prepare's process-wide thread setting)."""
    config, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    traffic.update(width=8, height=8, spp=2, check_jobs=2, check_runs=2, run_pixels=2)
    config["renderer"]["max_bounces"] = 4
    for k, v in overrides.items():
        (config["renderer"] if k in config["renderer"] else traffic)[k] = v
    return types.SimpleNamespace(config=config, traffic=traffic, seed=SEED, device=CPU,
                                 gen_dir=gen_dir)


def test_entry_runs_and_reads_correct(cell, gen_dir):
    entry = cell.entry()
    st = entry.setup(_ctx(cell, gen_dir))
    assert st.cfg.intersect == "bvh" and st.scene.bvh is not None
    for i in range(2):
        entry.collect(st, i, entry.job(st, i))
    entry.after_window(st)
    ref = entry.reference_outputs(st, torch.float32)
    readings = entry.judge(st, st.out, ref)
    assert set(readings) == set(cell.limits)
    assert all(v <= cell.limits[k] for k, v in readings.items()), readings
    assert len(st.out["rad"]) == 2 and sum(st.out["counts"]) > 0


@pytest.mark.parametrize("fault", ["config_off_the_route", "scene_without_a_tree"])
def test_entry_refuses_a_render_off_the_route(cell, gen_dir, monkeypatch, fault):
    entry = cell.entry()
    if fault == "config_off_the_route":
        ctx = _ctx(cell, gen_dir, intersect="auto")
        with pytest.raises(ValueError, match="BVH route"):
            entry.setup(ctx)
    else:
        monkeypatch.setattr(pbvh, "attach_bvh", lambda s, leaf_size=4: s)
        with pytest.raises(RuntimeError, match="no BVH"):
            entry.setup(_ctx(cell, gen_dir))


def _spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
            if e.name.startswith("ipt.")]


def _inside(spans, child, parent):
    kids = [s for s in spans if s[0] == child]
    assert kids, f"no {child} span"
    for n, a, b, th in kids:
        assert any(pn.startswith(parent) and pa <= a and b <= pb and pt == th
                   for pn, pa, pb, pt in spans if pn != child), (n, parent)


@pytest.fixture(scope="module")
def scene0():
    return load_scene(os.path.join(REPO, "scenes", "0.txt"), asset_root=ASSET_ROOT, with_bvh=True)


@pytest.mark.parametrize("where", ["pack_tables", "render"])
def test_prep_bvh_span_on_the_route_only(scene0, where):
    on = RenderConfig(width=2, height=2, spp=1, max_bounces=1, intersect="bvh")
    off = dataclasses.replace(on, intersect="auto")
    if where == "pack_tables":
        run = lambda cfg: pack_tables(scene0, scene0.diffuse, cfg)
        parent = "ipt.prep.tables"
    else:
        run = lambda cfg: forward.render_samples(scene0.diffuse, scene0, 3, cfg, device="cpu")
        parent = "ipt.launch."
    spans = _spans(lambda: run(on))
    _inside(spans, "ipt.prep.bvh", parent)
    assert not any(n == "ipt.prep.bvh" for n, *_ in _spans(lambda: run(off)))

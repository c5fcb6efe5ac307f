"""Batched recovery on the BVH route (RenderConfig.intersect="bvh"), the
benchmark's sphere1298bvhrecover configuration, on the CPU through the
plain versions; and the program counters that the benchmark's roofline of
B2's BVH instance reads.  Neither the port nor the benchmark's reference
imports JAX here.

  * The configuration's scene, built by the harness through the program's
    loader (benchmark/lib/program.py build_scene) with its tree from
    ops/bvh.py attach_bvh, is assets.large_scene(): the same 1298
    triangles, vertices and vertex normals; check_bvh passes.
  * Three steps of models/recover.py batched_step over 2 scenes on that
    scene and route, at 8x8, 4 spp and 6 bounces, against
    benchmark/reference/tracer.py recover_steps (a closest-hit sweep over
    every triangle, no tree): each step's losses, the first gradient and
    theta after the steps, within the tolerances with which
    benchmark/tests/test_bench_reference.py test_recovery_steps holds
    cornell30's dense route (the route's hits are the sweep's).
  * The cell's entry (benchmark/entries/recover_bvh.py) at a tiny size:
    setup, jobs, after_window, reference_outputs and judge read correct;
    it refuses a configuration off the route and a scene without a tree.
  * utils/profiling.py count in the mega backward (on scene 0 with its
    tree at 4x4, 2 spp and 3 bounces in launches of 16 samples, which the
    profiler records in seconds): ipt.grad.replayed is
    the forward's segments plus shadow rays of the same range,
    ipt.grad.lanes the range's samples and ipt.grad.rows the triangles
    times the launches; nothing is tallied without a profiler.
  * benchmark/metrics/grad_bvh_roofline.py on traced jobs, each of two
    traced runs in one process reading its own counts.
"""

import copy
import os
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, load_scene
from inverse_path_tracer_torch.assets import large_scene
from inverse_path_tracer_torch.models.recover import batched_step, make_optimizer
from inverse_path_tracer_torch.ops import bvh as pbvh
from inverse_path_tracer_torch.ops.kernels import clusters
from inverse_path_tracer_torch.render import forward
from inverse_path_tracer_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.lib import manifest, program  # noqa: E402
from benchmark.lib.trace import JOB_SPAN, Summary  # noqa: E402
from benchmark.reference import rng as rr  # noqa: E402
from benchmark.reference import tracer  # noqa: E402

CELL = "sphere1298bvh.recover4_bvh"
SEED = 2**31 + 2503
CPU = torch.device("cpu")
CFG = RenderConfig(width=8, height=8, spp=4, max_bounces=6, tile_size=128, intersect="bvh")
SCENES, STEPS, LR = 2, 3, 0.05
TINY = RenderConfig(width=4, height=4, spp=2, max_bounces=3, tile_size=16, intersect="bvh")


@pytest.fixture(scope="module")
def cell():
    return manifest.Cell(CELL)


@pytest.fixture(scope="module")
def gen_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gen"))


@pytest.fixture(scope="module")
def scene(cell, gen_dir):
    return pbvh.attach_bvh(program.build_scene(cell.config, gen_dir))


def test_config_scene_is_the_large_fixture_on_the_route(cell, scene):
    want = large_scene()
    assert scene.n_tri == want.n_tri == cell.config["triangles"] == 1298
    assert scene.has_vertex_normals and int(scene.emissive_idx.numel()) == cell.config["emissive"]
    torch.testing.assert_close(scene.vertices, want.vertices, rtol=0, atol=0)
    torch.testing.assert_close(scene.vertex_normals, want.vertex_normals, rtol=0, atol=0)
    pbvh.check_bvh(scene.bvh, scene.n_tri)
    assert cell.config["renderer"]["intersect"] == "bvh"
    assert clusters.uses_bvh(scene, CFG) and not forward._use_staged(CFG, scene)


def test_recovery_steps_on_the_bvh_route(cell, scene, gen_dir):
    targets = torch.rand((SCENES, CFG.height, CFG.width, 3),
                         generator=torch.Generator().manual_seed(11))
    keys = [[rr.fold_in(rr.fold_in(2**33 + 19, i), j) for j in range(SCENES)]
            for i in range(STEPS)]
    theta = torch.zeros((SCENES, scene.n_tri, 3), requires_grad=True)
    opt = make_optimizer(theta, LR)
    losses = []
    for i in range(STEPS):
        losses.append(batched_step(theta, opt, scene, keys[i], CFG, targets, device="cpu"))
        if i == 0:
            g1 = opt.state[theta]["exp_avg"] / 0.1
    rs = program.reference_scene(cell.config, gen_dir)
    steps, th = tracer.recover_steps(tracer.on(rs, "cpu", torch.float32), targets, keys, LR,
                                     CFG.width, CFG.height, CFG.spp, CFG.max_bounces, 0.9,
                                     pixels_per_chunk=16)
    for a, s in zip(losses, steps):
        torch.testing.assert_close(a.double(), s["losses"], rtol=1e-6, atol=0)
    assert bool((g1 != 0).any())
    torch.testing.assert_close(g1, steps[0]["grads"], rtol=1e-5, atol=1e-9)
    assert bool((theta.detach() != 0).any())
    torch.testing.assert_close(theta.detach(), th, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def scene0():
    return load_scene(os.path.join(REPO, "scenes", "0.txt"), asset_root=ASSET_ROOT, with_bvh=True)


def _ctx(cell, gen_dir, **overrides):
    """The entry's context, as benchmark/run.py prepare builds it, at a tiny
    size on the CPU (without prepare's process-wide thread setting)."""
    config, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    traffic.update(width=8, height=8, spp=2, scenes=2, ref_pixels_per_chunk=16)
    config["renderer"]["max_bounces"] = 4
    for k, v in overrides.items():
        (config["renderer"] if k in config["renderer"] else traffic)[k] = v
    return types.SimpleNamespace(config=config, traffic=traffic, seed=SEED, device=CPU,
                                 gen_dir=gen_dir)


def test_entry_runs_and_reads_correct(cell, gen_dir):
    entry = cell.entry()
    st = entry.setup(_ctx(cell, gen_dir))
    assert st.cfg.intersect == "bvh" and st.scene.bvh is not None
    assert len(st.out["losses"]) == cell.traffic["check_steps"]
    for i in range(2):
        entry.collect(st, i, entry.job(st, i))
    entry.after_window(st)
    ref = entry.reference_outputs(st, torch.float32)
    readings = entry.judge(st, st.out, ref)
    assert set(readings) == set(cell.limits)
    assert all(v <= cell.limits[k] for k, v in readings.items()), readings
    assert st.out["hits"] > 0 and st.least["hits"] == st.out["hits"]


@pytest.mark.parametrize("fault", ["config_off_the_route", "scene_without_a_tree"])
def test_entry_refuses_a_recovery_off_the_route(cell, gen_dir, monkeypatch, fault):
    entry = cell.entry()
    if fault == "config_off_the_route":
        with pytest.raises(ValueError, match="BVH route"):
            entry.setup(_ctx(cell, gen_dir, intersect="auto"))
    else:
        monkeypatch.setattr(pbvh, "attach_bvh", lambda s, leaf_size=4: s)
        with pytest.raises(RuntimeError, match="no BVH"):
            entry.setup(_ctx(cell, gen_dir))


def _mega_gradient(scene, key):
    kd = scene.diffuse.clone().requires_grad_()
    vals, stats = forward.render_samples(kd, scene, key, TINY, device="cpu")
    vals.sum().backward()
    return stats


def _traced(fn, jobs=1):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = []
        for _ in range(jobs):
            with record_function(JOB_SPAN):
                out.append(fn())
    return out, prof


def test_grad_counts_tally_only_under_a_profiler_and_are_the_forwards(scene0):
    scene = scene0
    assert clusters.uses_bvh(scene, TINY)
    before = dict(profiling._tally)
    _mega_gradient(scene, 4)
    assert profiling._tally == before
    (stats,), prof = _traced(lambda: _mega_gradient(scene, 4))
    got = profiling.counted(e.name() for e in prof.profiler.kineto_results.events())
    launches = -(-TINY.n_samples // TINY.tile_size)
    assert launches > 1
    assert got["ipt.grad.replayed"] == int(stats.segments) + int(stats.shadow_rays) > 0
    assert got["ipt.grad.lanes"] == TINY.n_samples
    assert got["ipt.grad.rows"] == scene.n_tri * launches
    assert profiling._tally == before


def test_the_roofline_reader_takes_each_traced_runs_own_counts(scene0):
    """Two traced runs in one process: each Summary's reader reads the
    counts of its own run's marks.  The CPU trace has no device operation,
    so one launch of B2's BVH instance of 1 ms a job is added to each
    Summary, beside one of the dense instance, which grad_bvh.ms leaves
    out."""
    roofline = manifest.metric_reader("grad_bvh_roofline")
    assert roofline.least_seconds(10**9, 0, 0) == pytest.approx(13e9 / 67e12)
    assert roofline.least_seconds(0, 10, 2) == pytest.approx((10 + 2) * 12 / 3.35e12)
    readings = []
    for key, jobs in ((3, 1), (8, 2)):
        stats, prof = _traced(lambda: _mega_gradient(scene0, key), jobs)
        s = Summary.from_profiler(prof, entry="recover_bvh", least_s_per_job=None,
                                  port_kernels={})
        a, _ = s.jobs[0]
        s.device_ops += [("void grad_tile_kernel<16, false, 2>(TraceParams, float const*)", a,
                          a + 1e-3 * jobs),
                         ("void grad_tile_kernel<16, false, 0>(TraceParams, float const*)", a,
                          a + 5e-3)]
        ms = manifest.metric_reader("grad_bvh.ms").read(s)
        assert ms == pytest.approx(1.0, rel=1e-3)  # host clock seconds: ~1e-7 s apart
        replayed = sum(int(st.segments) + int(st.shadow_rays) for st in stats)
        launches = -(-TINY.n_samples // TINY.tile_size)
        want = (100.0 * roofline.least_seconds(replayed, jobs * TINY.n_samples,
                                               jobs * scene0.n_tri * launches)
                / jobs / (ms * 1e-3))
        readings.append((roofline.read(s), want))
        assert roofline.read(s) is None  # read once
    for got, want in readings:
        assert got == pytest.approx(want, rel=1e-12)
    assert readings[0][1] != readings[1][1]

"""Batched recovery through the staged gradient route, on the CPU through
the plain versions, against the benchmark's plain reference; and the
program counter that the benchmark's B9 roofline reads.  Neither the port
nor the reference imports JAX here.

  * A small clustered vertex-normal scene: the sphere1298 configuration's
    box with its generated sphere cut to 5 rings x 14 segments (112
    triangles, 130 in all, 136 padded: clustered, so wavefront "auto" is
    staged), at 6 bounces in stages of 4 (two stages: the re-sort and B9's
    plain version run in reverse).  Three steps of models/recover.py
    batched_step over 3 scenes against benchmark/reference/tracer.py
    recover_steps, as benchmark/tests/test_bench_reference.py
    test_recovery_steps holds cornell30's dense route: each step's losses,
    the first gradient and theta after the steps.  Tolerances: the two sum
    in different orders, and the plain staged versions round a few lanes'
    shading differently on vertex-normal scenes (ROADMAP §C).  Over three
    seeds the losses differed by at most 1.3e-7 of their value, the
    gradient by 1.2e-9 (entries up to 6e-3) and theta by 2e-7, so the
    limits sit about ten times above: losses rtol 1e-6, the gradient rtol
    1e-4 with atol 1e-8, theta rtol 1e-4 with atol 1e-6.
  * utils/profiling.py count: tallies only while a profiler session
    records, its marks name their entries, counted reads each entry once;
    in the staged gradient ipt.staged.records equals the replay's segments
    (the forward's, the same samples) and ipt.staged.reverse_lanes the
    lanes of B9's launches; ipt.prep.morton counts one a Morton order.
  * The spans ipt.staged.replay (inside ipt.render.grad) and
    ipt.staged.reverse (around B9's launches) under a profiler; and
    benchmark/metrics/stage_reverse_roofline.py on a traced job, each of
    two traced runs in one process reading its own counts.
"""

import copy
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import RenderConfig
from inverse_path_tracer_torch.models.recover import batched_step, make_optimizer
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

CFG = RenderConfig(width=8, height=8, spp=4, max_bounces=6, tile_size=128)
SCENES, STEPS, LR = 3, 3, 0.05


@pytest.fixture(scope="module")
def config():
    cfg = copy.deepcopy(manifest.read_json(f"{manifest.BENCH_DIR}/configs/sphere1298.json"))
    cfg["objects"][1]["sphere"].update(rings=5, segments=14)
    return cfg


@pytest.fixture(scope="module")
def scenes(config, tmp_path_factory):
    gen = str(tmp_path_factory.mktemp("gen"))
    return program.build_scene(config, gen), program.reference_scene(config, gen)


def test_the_scene_takes_the_staged_route(scenes):
    ps, _ = scenes
    assert ps.n_tri == 130 and ps.has_vertex_normals
    assert clusters.cluster_k_for(ps.n_tri, CFG) > 0 and forward._use_staged(CFG, ps)
    assert forward._stage_plan(CFG) == (4, 2)


def test_recovery_steps_on_the_staged_route(scenes):
    ps, rs = scenes
    targets = torch.rand((SCENES, CFG.height, CFG.width, 3),
                         generator=torch.Generator().manual_seed(5))
    keys = [[rr.fold_in(rr.fold_in(2**33 + 7, i), j) for j in range(SCENES)]
            for i in range(STEPS)]
    theta = torch.zeros((SCENES, ps.n_tri, 3), requires_grad=True)
    opt = make_optimizer(theta, LR)
    losses = []
    for i in range(STEPS):
        losses.append(batched_step(theta, opt, ps, keys[i], CFG, targets, device="cpu"))
        if i == 0:
            g1 = opt.state[theta]["exp_avg"] / 0.1
    steps, th = tracer.recover_steps(tracer.on(rs, "cpu", torch.float32), targets, keys, LR,
                                     CFG.width, CFG.height, CFG.spp, CFG.max_bounces, 0.9,
                                     pixels_per_chunk=16)
    for a, s in zip(losses, steps):
        torch.testing.assert_close(a.double(), s["losses"], rtol=1e-6, atol=0)
    assert bool((g1 != 0).any())
    torch.testing.assert_close(g1, steps[0]["grads"], rtol=1e-4, atol=1e-8)
    torch.testing.assert_close(theta.detach(), th, rtol=1e-4, atol=1e-6)


def test_count_tallies_only_under_a_profiler():
    before = dict(profiling._tally)
    profiling.count("ipt.test.n", torch.ones(5))
    assert profiling._tally == before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.count("ipt.test.n", torch.ones(5))
        profiling.count("ipt.test.n", 3)
        profiling.count("ipt.test.m", torch.tensor([2.0, 4.0]))
    marks = [e.name for e in prof.events() if e.name.startswith(profiling.COUNT_MARK)]
    assert len(marks) == 3 and all(m.startswith("ipt.count.ipt.test.") for m in marks)
    assert profiling.counted(marks + ["aten::add", "ipt.render.range"]) == {
        "ipt.test.n": 8, "ipt.test.m": 6}
    assert profiling.counted(marks) == {}  # each entry is read once
    assert profiling._tally == before


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(JOB_SPAN):
            out = fn()
    return out, prof


def _staged_gradient(ps, key):
    kd = ps.diffuse.clone().requires_grad_()
    vals, stats = forward.render_samples(kd, ps, key, CFG, device="cpu")
    vals.sum().backward()
    return stats


def test_the_records_count_is_the_replays_segments(scenes):
    ps, _ = scenes
    stats, prof = _traced(lambda: _staged_gradient(ps, 9))
    marks = [e.name for e in prof.events() if e.name.startswith(profiling.COUNT_MARK)]
    got = profiling.counted(marks)
    _, n_stages = forward._stage_plan(CFG)
    assert got["ipt.staged.records"] == int(stats.segments) > 0
    assert got["ipt.staged.reverse_lanes"] == CFG.n_samples * n_stages


def test_the_morton_count_is_one_an_order(scenes):
    """ipt.prep.morton counts each Morton order computed: kernel_perm's and
    kernel_view's one each, none where the scene keeps its global order
    (tri_order "file") or is swept dense (cfg None)."""
    ps, _ = scenes

    def orders(fn):
        _, prof = _traced(fn)
        return profiling.counted(e.name for e in prof.events()).get("ipt.prep.morton", 0)

    assert orders(lambda: clusters.kernel_perm(ps, CFG)) == 1
    assert orders(lambda: clusters.kernel_view(ps, CFG)) == 1
    assert orders(lambda: clusters.kernel_perm(ps, CFG.with_(tri_order="file"))) == 0
    assert orders(lambda: clusters.kernel_view(ps, None)) == 0


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
            if e.name.startswith("ipt.")]


def _inside(spans, child, parent):
    kids = [s for s in spans if s[0] == child]
    assert kids, child
    for n, a, b, th in kids:
        assert any(pn == parent and pa <= a and b <= pb and pt == th
                   for pn, pa, pb, pt in spans), (child, parent)


def test_replay_and_reverse_spans(scenes):
    ps, _ = scenes
    targets = torch.rand((2, CFG.height, CFG.width, 3), generator=torch.Generator().manual_seed(1))
    theta = torch.zeros((2, ps.n_tri, 3), requires_grad=True)
    opt = make_optimizer(theta, LR)
    _, prof = _traced(lambda: batched_step(theta, opt, ps, [4, 5], CFG, targets, device="cpu"))
    spans = _spans(prof)
    launches = -(-CFG.n_samples // CFG.tile_size)
    assert sum(s[0] == "ipt.staged.replay" for s in spans) == 2 * launches
    assert sum(s[0] == "ipt.staged.reverse" for s in spans) == 2 * launches
    _inside(spans, "ipt.staged.replay", "ipt.render.grad")
    _inside(spans, "ipt.staged.reverse", "ipt.render.grad")
    _inside(spans, "ipt.launch.stage_reverse_tile", "ipt.staged.reverse")
    profiling.counted(e.name for e in prof.events())  # drop this run's entries


def test_the_roofline_reader_takes_each_traced_runs_own_counts(scenes):
    """Two traced runs in one process: each Summary's reader reads the
    counts of its own run's marks.  The CPU trace has no device operation,
    so one B9 launch of 1 ms a job is added to each Summary."""
    ps, _ = scenes
    roofline = manifest.metric_reader("stage_reverse_roofline")
    assert roofline.least_bytes(10, 2) == 10 * 64 + 2 * 44
    readings = []
    for key, jobs in ((3, 1), (8, 2)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            stats = []
            for j in range(jobs):
                with record_function(JOB_SPAN):
                    stats.append(_staged_gradient(ps, key + j))
        s = Summary.from_profiler(prof, entry="recover", least_s_per_job=None, port_kernels={})
        a, b = s.jobs[0]
        s.device_ops.append(("void stage_reverse_kernel<4, false>(float const*)", a,
                             a + 1e-3 * jobs))
        ms = manifest.metric_reader("stage_reverse.ms").read(s)
        assert ms == pytest.approx(1.0, rel=1e-3)  # host clock seconds: ~1e-7 s apart
        records = sum(int(st.segments) for st in stats)
        lanes = jobs * CFG.n_samples * forward._stage_plan(CFG)[1]
        want = 100.0 * roofline.least_bytes(records, lanes) / 3.35e12 / jobs / (ms * 1e-3)
        readings.append((roofline.read(s), want))
        assert roofline.read(s) is None  # read once
    for got, want in readings:
        assert got == pytest.approx(want, rel=1e-12)
    assert readings[0][1] != readings[1][1]

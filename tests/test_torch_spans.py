"""The port's program spans (utils/profiling.py span, ipt.<layer>.<what>)
on the CPU, through the plain versions.

  * Under torch.profiler, render_samples on a clustered, staged small
    scene, batched_step and extract_graph emit their spans with the
    documented nesting: ipt.launch.* inside ipt.render.* or
    ipt.extract.range, ipt.staged.reorder and ipt.prep.bins inside
    ipt.render.range, ipt.launch.reorder_tile inside ipt.staged.reorder,
    ipt.prep.perm inside ipt.prep.tables (pack_tables, which the card's
    routes call once per range) and inside the plain versions' launches, the recovery's loss, backward and optimizer spans
    inside ipt.recover.step.
  * With no profiler, record_function is never entered: it is patched to
    raise, and every path runs.
  * Outputs and RenderStats are bit-equal with and without a profiler.
"""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, load_scene
from inverse_path_tracer_torch.models.recover import batched_step, make_optimizer
from inverse_path_tracer_torch.ops.kernels import clusters
from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
from inverse_path_tracer_torch.render.forward import render_image, render_samples
from inverse_path_tracer_torch.render.inverse import extract_graph
from inverse_path_tracer_torch.utils import profiling
from inverse_path_tracer_torch.utils.profiling import span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
# Two launches of two stages each (stage_bounces 4).
STAGED = RenderConfig(width=8, height=8, spp=2, max_bounces=6, tile_size=64)
SMALL = RenderConfig(width=8, height=8, spp=2, max_bounces=3, tile_size=64)


@pytest.fixture(scope="module")
def scene():
    return load_scene(os.path.join(REPO, "scenes", "0.txt"), asset_root=ASSET_ROOT)


@pytest.fixture()
def small_clusters(monkeypatch):
    """Clusters (and so the staged wavefront) on scene 0."""
    monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 8)


def traced(fn):
    """fn's result and its ipt.* spans [(name, start, end, thread)]; the
    counters' marks (ipt.count.*, profiling.count) are not spans."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
             if e.name.startswith("ipt.") and not e.name.startswith(profiling.COUNT_MARK)]
    profiling.counted(e.name for e in prof.events())  # drop this run's counts
    return out, spans


def names(spans):
    return {n for n, *_ in spans}


def inside(spans, child: str, parents):
    """Every span named `child` (a prefix ending in '.' matches a family)
    lies inside a span of one of `parents` on its thread."""
    kids = [s for s in spans if s[0].startswith(child)]
    assert kids, f"no {child} span"
    for kid in kids:
        n, a, b, th = kid
        assert any(pn.startswith(p) and pa <= a and b <= pb and pt == th and (pn, pa, pb, pt) != kid
                   for pn, pa, pb, pt in spans for p in parents), (n, parents)


def test_render_spans_and_nesting(scene, small_clusters):
    (vals, _), spans = traced(lambda: render_samples(scene.diffuse, scene, 3, STAGED, **CPU))
    assert names(spans) == {"ipt.render.range", "ipt.prep.perm", "ipt.prep.bins",
                            "ipt.staged.reorder", "ipt.launch.init_tile",
                            "ipt.launch.stage_tile", "ipt.launch.reorder_tile"}
    n = lambda name: sum(s[0] == name for s in spans)
    launches = -(-STAGED.n_samples // STAGED.tile_size)
    assert n("ipt.render.range") == 1 and n("ipt.launch.init_tile") == launches
    assert (n("ipt.staged.reorder") == n("ipt.launch.stage_tile") == n("ipt.launch.reorder_tile")
            == 2 * launches)
    for child in ("ipt.launch.", "ipt.staged.reorder", "ipt.prep.bins"):
        inside(spans, child, ["ipt.render.range"])
    inside(spans, "ipt.launch.reorder_tile", ["ipt.staged.reorder"])
    # the range's own permutation, and the plain versions' views in each launch
    inside(spans, "ipt.prep.perm", ["ipt.render.range", "ipt.launch."])


def test_pack_tables_nests_the_permutation(scene, small_clusters):
    tabs, spans = traced(lambda: pack_tables(scene, scene.diffuse, STAGED))
    assert tabs.cluster_k > 0 and names(spans) == {"ipt.prep.tables", "ipt.prep.perm"}
    inside(spans, "ipt.prep.perm", ["ipt.prep.tables"])


def test_render_gradient_spans(scene, small_clusters):
    kd = scene.diffuse.clone().requires_grad_()

    def run():
        vals, _ = render_samples(kd, scene, 3, STAGED, **CPU)
        vals.sum().backward()

    _, spans = traced(run)
    assert {"ipt.render.grad", "ipt.launch.stage_reverse_tile"} <= names(spans)
    inside(spans, "ipt.launch.stage_reverse_tile", ["ipt.render.grad"])
    inside(spans, "ipt.staged.reorder", ["ipt.render.range", "ipt.render.grad"])


def _targets(scene):
    return torch.stack([render_image(scene.diffuse * f, scene, 9, SMALL, **CPU)
                        for f in (1.0, 0.5)])


def _batched(scene, targets):
    theta = torch.zeros((2, scene.n_tri, 3), requires_grad=True)
    opt = make_optimizer(theta, 0.1)
    losses = batched_step(theta, opt, scene, [4, 5], SMALL, targets, **CPU)
    return losses, theta.detach().clone()


def test_batched_step_spans(scene):
    targets = _targets(scene)
    _, spans = traced(lambda: _batched(scene, targets))
    got = names(spans)
    assert {"ipt.recover.step", "ipt.recover.loss", "ipt.recover.backward", "ipt.recover.optim",
            "ipt.render.range", "ipt.render.grad", "ipt.launch.render_tile",
            "ipt.launch.grad_tile"} <= got
    assert not any(n.startswith(("ipt.staged.", "ipt.prep.perm")) for n in got)  # dense, mega
    assert sum(s[0] == "ipt.recover.step" for s in spans) == 1
    for child in ("ipt.recover.loss", "ipt.recover.backward", "ipt.recover.optim",
                  "ipt.render."):
        inside(spans, child, ["ipt.recover.step"])
    assert sum(s[0] == "ipt.recover.optim" for s in spans) == 2  # zero_grad, step
    inside(spans, "ipt.launch.render_tile", ["ipt.render.range"])
    inside(spans, "ipt.launch.grad_tile", ["ipt.render.grad"])
    inside(spans, "ipt.render.grad", ["ipt.recover.backward"])


def test_extract_spans(scene, small_clusters):
    cfg = SMALL.with_(max_bounces=4)
    target = render_image(scene.diffuse, scene, 1, cfg, **CPU)
    _, spans = traced(lambda: extract_graph(scene, target, 0, cfg, **CPU))
    assert names(spans) == {"ipt.extract.range", "ipt.prep.perm", "ipt.prep.grid",
                            "ipt.launch.inverse_tile", "ipt.extract.finish",
                            "ipt.extract.compress"}
    for child in ("ipt.prep.grid", "ipt.launch.inverse_tile", "ipt.extract.finish"):
        inside(spans, child, ["ipt.extract.range"])
    inside(spans, "ipt.prep.perm", ["ipt.extract.range"])
    assert sum(s[0] == "ipt.launch.inverse_tile" for s in spans) == -(-cfg.n_samples // 64)


def _all_paths(scene, targets):
    """Every path above once: (render values, stats), the render's
    gradient, (losses, theta), the graph."""
    render = render_samples(scene.diffuse, scene, 3, STAGED, **CPU)
    kd = scene.diffuse.clone().requires_grad_()
    vals, _ = render_samples(kd, scene, 3, STAGED, **CPU)
    vals.sum().backward()
    return (render, kd.grad, _batched(scene, targets),
            extract_graph(scene, targets[0], 0, SMALL, **CPU))


def test_no_profiler_enters_no_record_function(scene, small_clusters, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    _all_paths(scene, _targets(scene))
    with pytest.raises(AssertionError):  # the patch is what span would call
        with profile(activities=[ProfilerActivity.CPU]):
            with span("ipt.test"):
                pass


def test_outputs_bit_equal_with_and_without_a_profiler(scene, small_clusters):
    targets = _targets(scene)
    plain = _all_paths(scene, targets)
    with_prof, spans = traced(lambda: _all_paths(scene, targets))
    assert len(names(spans)) > 10
    flat = lambda x: [t for y in x for t in (flat(y) if isinstance(y, tuple) else [y])]
    a, b = flat(plain), flat(with_prof)
    assert len(a) == len(b) == 9  # values, 2 counts, gradient, losses, theta, w, pixel, light
    for x, y in zip(a, b):
        assert torch.equal(x, y)

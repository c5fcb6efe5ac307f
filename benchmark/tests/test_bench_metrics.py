"""The per-layer readers on a synthetic trace, the floor arithmetic, and
the floor's independence of the program's route."""

import math

import pytest

from benchmark.lib import floors, manifest
from benchmark.lib.trace import Summary, merge, short, symbol

PORT = {"render_fwd": ["render_kernel", "stage_kernel"]}


def _summary(entry="render", least=None):
    # Two jobs of 10 ms each; the program's kernels 4 + 3 ms, PyTorch's 1 ms
    # overlapping one of them by 0.5 ms, and a copy of 1 ms.
    dev = [("void render_kernel<false, 0>(TraceParams, float*)", 0.001, 0.005),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 0.0045, 0.0055),
           ("void stage_kernel<true>(TraceParams)", 0.012, 0.015),
           ("Memcpy DtoH (Device -> Pageable)", 0.016, 0.017),
           ("void render_kernel<false, 0>(TraceParams, float*)", 0.0205, 0.0215)]  # between jobs
    host = [("aten::sort", 0.0055, 0.0119), ("cudaStreamSynchronize", 0.017, 0.02)]
    jobs = [(0.0, 0.01), (0.01, 0.02)]
    return Summary(dev, host, jobs, entry=entry, least_s_per_job=least, port_kernels=PORT)


def _read(name, s):
    return manifest.metric_reader(name).read(s)


def test_symbols():
    assert symbol("void render_kernel<false, 0>(TraceParams, float*)") == "render_kernel"
    assert symbol("void at::native::(anonymous namespace)::sort_kernel(int)") == "sort_kernel"
    assert short("void stage_kernel<true>(TraceParams)") == "stage_kernel<true>"
    assert short("void (anonymous namespace)::init_kernel<1>(P)") == "init_kernel<1>"
    assert merge([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_busy_idle_and_split():
    s = _summary()
    assert s.n_jobs == 2 and math.isclose(s.window_s, 0.02)
    # union: [1, 5.5] + [12, 15] + [16, 17] ms; the kernel between jobs is left out
    assert math.isclose(s.busy_s, 0.0045 + 0.003 + 0.001)
    assert math.isclose(_read("device.idle_pct", s), 100 * (1 - 0.0085 / 0.02))
    assert math.isclose(_read("kernels.ms", s), (0.004 + 0.003) / 2 * 1e3)
    assert math.isclose(_read("forward.torch_ms", s), (0.001 + 0.001) / 2 * 1e3)
    assert _read("recover.torch_ms", s) is None and _read("extract.torch_ms", s) is None
    assert _read("kernels_roofline", s) is None  # no least work given: nothing to read


def test_roofline_share():
    least = floors.least_seconds(hits=1e9, nbytes=1e6)
    assert math.isclose(least, 13e9 / 67e12)
    assert math.isclose(floors.least_seconds(hits=1, nbytes=3.35e9), 1e-3)
    s = _summary(least=least)
    assert math.isclose(_read("kernels_roofline", s), 100 * least / 0.0035)


def test_breakdown():
    s = _summary()
    top = s.device_ops_top()
    assert top[0][0] == "render_kernel<false, 0>" and math.isclose(top[0][1], 0.004)
    gaps = s.idle_gaps_top()
    assert gaps[0][0] == "aten::sort" and math.isclose(gaps[0][1], 0.0065)
    assert gaps[1][0] == "cudaStreamSynchronize" and math.isclose(gaps[1][1], 0.003)


@pytest.mark.parametrize("route", [dict(wavefront="mega"), dict(wavefront="staged"),
                                   dict(intersect="brute"), dict(intersect="bvh")])
def test_floor_does_not_depend_on_the_route(route, gen_dir):
    """Hits (shadow rays) and bytes of one scene's job are the same under
    every organisation of the program's wavefront and search."""
    import inverse_path_tracer_torch as ipt
    from inverse_path_tracer_torch.ops.bvh import attach_bvh

    from benchmark.lib import program

    cfg_json = manifest.read_json(f"{manifest.BENCH_DIR}/configs/sphere1298.json")
    scene = attach_bvh(program.build_scene(cfg_json, gen_dir))
    cfg = ipt.RenderConfig(width=6, height=6, spp=2, max_bounces=5)
    _, base = ipt.render_samples(scene.diffuse, scene, 5, cfg, device="cpu")
    _, st = ipt.render_samples(scene.diffuse, scene, 5, cfg.with_(**route), device="cpu")
    assert int(st.shadow_rays) == int(base.shadow_rays) > 0
    nb = floors.scene_bytes(scene.n_tri, True) + cfg.n_samples * 12
    assert floors.least_seconds(int(st.shadow_rays), nb) == floors.least_seconds(
        int(base.shadow_rays), nb)

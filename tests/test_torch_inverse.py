"""The port's transport-graph extraction (render/inverse.py) on the CPU.

  * The plain wavefront path (backend="plain") against the JAX XLA path
    (backend="xla") on JAX's own camera rays and _inv_uniforms of one tile:
    scene 0, a small vertex-normal sphere in the box, and p_spec = 0.25.
    Every TransportGrids field, both channels, rtol 1e-4 / atol 1e-5, and
    visit counts equal.
  * The kernel route (backend="auto", the B5/B6 plain versions on the CPU)
    against the wavefront path on the same rays: DIFFUSE channel rtol 1e-4 /
    atol 1e-5, counts equal.  The route takes B5 (inverse_tile) where
    inverse_grid_fits and B6's global-grid sink (inverse_tile_global)
    elsewhere, never the records sink; the global route against the JAX XLA
    path on a vertex-normal scene past inverse_grid_fits, on JAX's rays and
    _inv_uniforms, the same tolerance.
  * compress_grids against JAX on random grids (negative w_sum, zero
    factors) and on the hand-built case of tests/test_inverse.py:103.
  * The fused RNG: the camera and the bounce loop read disjoint counter-hash
    slots; ranges sum to the whole; an extract_graph drive is sane.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.render import inverse as jinv
from inverse_path_tracer_tpu.render.forward import camera_rays as jax_camera_rays

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, scene_from_numpy
from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.render.inverse import (
    TransportGrids,
    compress_grids,
    extract_graph,
    trace_transport_range,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
RTOL, ATOL = 1e-4, 1e-5
CPU = dict(device="cpu")


def jax_scene(kind, tmp_path, rings=4, segments=6):
    if kind == "cornell":
        return jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    from inverse_path_tracer_tpu.scene.build import build_scene
    from inverse_path_tracer_tpu.scene.dsl import ObjectParams

    obj = tmp_path / "sphere.obj"
    obj.write_text(sphere_obj_text(rings=rings, segments=segments))
    box = ObjectParams(pos=(0, 0, 4), scl=(2, 2, 2),
                       obj_file="CornellBox/CornellBox-Empty-CO.obj",
                       mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    ball = ObjectParams(pos=(0, -1.5, 4), obj_file=str(obj), mtl_file="*Kd 0.5 0.5 0.5*")
    return build_scene([box, ball], asset_root=ASSET_ROOT)


def port_scene(js):
    return scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})


def target(cfg, seed=0):
    return np.random.default_rng(seed).random((cfg.height, cfg.width, 3)).astype(np.float32)


def jax_inputs(js, jcfg, key):
    """The rays and uniforms of the XLA path's one tile (inverse.py:585-600)."""
    n = jcfg.n_samples
    tkey = jax.random.fold_in(key, 0)
    p, d = jax_camera_rays(js, jcfg, tkey, jnp.arange(n, dtype=jnp.int32))
    u = jinv._inv_uniforms(tkey, jcfg, n)
    return tuple(torch.from_numpy(np.array(a)) for a in (p, d, u))


def assert_grids_close(got, want, channels=(0, 1)):
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.w_sum.numpy(), np.asarray(want.w_sum), rtol=RTOL, atol=ATOL)
    for name in ("pixel_sum", "light_sum", "factors_sum"):
        for c in channels:
            np.testing.assert_allclose(getattr(got, name)[:, c].numpy(),
                                       np.asarray(getattr(want, name))[:, c],
                                       rtol=RTOL, atol=ATOL, err_msg=f"{name}[{c}]")


CASES = [("cornell", 0.0), ("sphere", 0.0), ("cornell", 0.25)]


@pytest.mark.parametrize("kind,p_spec", CASES)
def test_wavefront_matches_jax_xla(kind, p_spec, tmp_path):
    js = jax_scene(kind, tmp_path)
    ts = port_scene(js)
    if kind == "sphere":
        assert ts.has_vertex_normals
    shape = dict(width=8, height=8, spp=4, max_bounces=6, tile_size=256, p_spec=p_spec)
    jcfg = jipt.RenderConfig(backend="xla", **shape)
    key = jax.random.PRNGKey(3 + len(kind))
    img = target(jcfg)
    want = jinv.trace_transport_range(js, jnp.asarray(img), key, jcfg, jnp.int32(0),
                                      jcfg.n_samples)
    p, d, u = jax_inputs(js, jcfg, key)
    tcfg = RenderConfig(backend="plain", rng="external", **shape)
    got, _ = trace_transport_range(ts, torch.from_numpy(img), 0, tcfg, 0, tcfg.n_samples,
                                   rays=(p, d), uniforms=u, **CPU)
    assert_grids_close(got, want)
    assert float(got.count.sum()) > tcfg.n_samples  # the paths do bounce
    if p_spec > 0:
        assert float(got.factors_sum[:, 1].abs().sum()) > 0


@pytest.mark.parametrize("kind", ["cornell", "sphere"])
def test_kernel_route_matches_wavefront(kind, tmp_path):
    """backend="auto" on the CPU (B5's or B6's plain version and the records
    reduction) against the wavefront path: the DIFFUSE channel and counts."""
    ts = port_scene(jax_scene(kind, tmp_path))
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=6, tile_size=100)
    img = torch.from_numpy(target(cfg, seed=1))
    plain, plain_stats = trace_transport_range(ts, img, 9, cfg.with_(backend="plain"), 0,
                                               cfg.n_samples, **CPU)
    auto, stats = trace_transport_range(ts, img, 9, cfg, 0, cfg.n_samples, **CPU)
    assert_grids_close(auto, plain, channels=(0,))
    assert [int(x) for x in stats] == [int(x) for x in plain_stats]
    assert int(stats.segments) >= int(auto.count[-ts.n_tri:].sum())  # eye edges <= segments
    assert int(stats.shadow_rays) > 0


@pytest.mark.parametrize("kind,route", [("cornell", "grid"), ("big_sphere", "global")])
def test_extraction_route_choice(kind, route, tmp_path, monkeypatch):
    """B5 where its grid fits shared memory, B6's global-grid sink past it;
    the records sink is on neither route, and the route module reaches
    neither it nor the records reduction (on the CPU the plain versions
    reduce records themselves)."""
    from inverse_path_tracer_torch.ops.kernels import inverse_kernel as ik
    from inverse_path_tracer_torch.render import inverse as rinv

    js = jax_scene("cornell" if kind == "cornell" else "sphere", tmp_path, rings=6, segments=8)
    ts = port_scene(js)
    assert ik.inverse_grid_fits(ts) is (route == "grid")
    calls = {"grid": 0, "global": 0, "records": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(rinv, "inverse_tile", spy("grid", rinv.inverse_tile))
    monkeypatch.setattr(rinv, "inverse_tile_global", spy("global", rinv.inverse_tile_global))
    monkeypatch.setattr(ik, "inverse_tile_rec", spy("records", ik.inverse_tile_rec))
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=4, tile_size=64)
    trace_transport_range(ts, torch.from_numpy(target(cfg)), 2, cfg, 0, cfg.n_samples, **CPU)
    assert calls == {"grid": 2 if route == "grid" else 0, "global": 2 if route == "global" else 0,
                     "records": 0}
    assert not hasattr(rinv, "inverse_tile_rec") and not hasattr(rinv, "grids_from_edge_records")


def test_global_route_matches_jax_xla(tmp_path):
    """The global-grid route (B6's plain twin on the CPU) on a vertex-normal
    scene past inverse_grid_fits against the JAX XLA path on JAX's rays and
    _inv_uniforms: the DIFFUSE channel and counts, as
    test_kernel_route_matches_wavefront holds the kernel route."""
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import inverse_grid_fits

    js = jax_scene("sphere", tmp_path, rings=6, segments=8)
    ts = port_scene(js)
    assert ts.has_vertex_normals and not inverse_grid_fits(ts)
    shape = dict(width=8, height=8, spp=4, max_bounces=6, tile_size=100)
    jcfg = jipt.RenderConfig(backend="xla", **{**shape, "tile_size": 256})
    key = jax.random.PRNGKey(11)
    img = target(jcfg, seed=3)
    want = jinv.trace_transport_range(js, jnp.asarray(img), key, jcfg, jnp.int32(0),
                                      jcfg.n_samples)
    p, d, u = jax_inputs(js, jcfg, key)
    tcfg = RenderConfig(rng="external", **shape)
    got, stats = trace_transport_range(ts, torch.from_numpy(img), 0, tcfg, 0, tcfg.n_samples,
                                       rays=(p, d), uniforms=u, **CPU)
    assert_grids_close(got, want, channels=(0,))
    assert float(got.count.sum()) > tcfg.n_samples and int(stats.shadow_rays) > 0


def test_clustered_extraction_matches_dense(tmp_path, monkeypatch):
    """The 242-triangle vertex-normal scene (248 padded) is clustered at this
    card's threshold; its extraction, in the kernels' internal order mapped
    back once per range, equals the dense one in global order."""
    from inverse_path_tracer_torch.ops.kernels import clusters

    ts = port_scene(jax_scene("sphere", tmp_path, rings=8, segments=16))
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=4, tile_size=64)
    assert ts.n_tri == 242 and clusters.cluster_k_for(ts.n_tri, cfg) == 16
    img = torch.from_numpy(target(cfg, seed=4))
    clustered, stats = trace_transport_range(ts, img, 6, cfg, 0, cfg.n_samples, **CPU)
    monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 512)
    dense, dense_stats = trace_transport_range(ts, img, 6, cfg, 0, cfg.n_samples, **CPU)
    assert_grids_close(clustered, dense, channels=(0,))
    assert [int(x) for x in stats] == [int(x) for x in dense_stats]
    assert float(clustered.count.sum()) > cfg.n_samples


def test_ranges_sum_and_fused_is_deterministic():
    ts = port_scene(jipt.load_scene(SCENE0, asset_root=ASSET_ROOT))
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=5, tile_size=64)
    img = torch.from_numpy(target(cfg, seed=2))
    n = cfg.n_samples
    full, _ = trace_transport_range(ts, img, 4, cfg, 0, n, **CPU)
    a, _ = trace_transport_range(ts, img, 4, cfg, 0, 100, **CPU)
    b, _ = trace_transport_range(ts, img, 4, cfg.with_(tile_size=50), 100, n - 100, **CPU)
    for f, x, y in zip(full._fields, full, (u + v for u, v in zip(a, b))):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5, msg=f)
    again, _ = trace_transport_range(ts, img, 4, cfg, 0, n, **CPU)
    assert all(torch.equal(x, y) for x, y in zip(full, again))


def test_fused_camera_and_bounces_read_disjoint_slots(monkeypatch):
    """With one key the inverse loop's slot 6 of bounce 0 would be the
    camera's x jitter; the extraction must never read one (key, counter)
    from both."""
    ts = port_scene(jipt.load_scene(SCENE0, asset_root=ASSET_ROOT))
    cfg = RenderConfig(width=4, height=4, spp=2, max_bounces=3)
    reads = {"camera": set(), "bounce": set()}
    draw = rng.draw

    def spy(keys, h_orig, bounce, slots=range(8)):
        import inspect

        caller = inspect.stack()[1].function
        kind = "camera" if caller == "camera_rays" else "bounce"
        reads[kind].update((tuple(keys), bounce * 8 + s) for s in slots)
        return draw(keys, h_orig, bounce, slots)

    monkeypatch.setattr(rng, "draw", spy)
    for backend in ("auto", "plain"):
        trace_transport_range(ts, torch.zeros(4, 4, 3), 7, cfg.with_(backend=backend), 0,
                              cfg.n_samples, **CPU)
    assert reads["camera"] and reads["bounce"]
    assert {c for _, c in reads["bounce"]} >= {6}  # theta of bounce 0 is read
    assert not reads["camera"] & reads["bounce"]


def test_p_spec_needs_the_plain_backend():
    ts = port_scene(jipt.load_scene(SCENE0, asset_root=ASSET_ROOT))
    cfg = RenderConfig(width=4, height=4, spp=1, max_bounces=2, p_spec=0.25)
    with pytest.raises(ValueError, match="p_spec"):
        trace_transport_range(ts, torch.zeros(4, 4, 3), 0, cfg, 0, cfg.n_samples, **CPU)
    grids, _ = trace_transport_range(ts, torch.zeros(4, 4, 3), 0, cfg.with_(backend="plain"), 0,
                                     cfg.n_samples, **CPU)
    assert float(grids.count.sum()) > 0


def random_grids(n_tri, seed):
    g = np.random.default_rng(seed)
    b = (n_tri + 1) * n_tri
    f = g.uniform(0, 2, (b, 2)).astype(np.float32)
    f[g.random((b, 2)) < 0.3] = 0.0  # zero factors divide by 1
    return dict(w_sum=g.uniform(-3, 40, b).astype(np.float32),  # some below -1
                pixel_sum=g.uniform(0, 5, (b, 2, 3)).astype(np.float32),
                light_sum=g.uniform(0, 9, (b, 2, 3)).astype(np.float32),
                factors_sum=f, count=g.integers(0, 9, b).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_matches_jax(seed):
    n_tri = 7
    arrays = random_grids(n_tri, seed)
    arrays["w_sum"][: n_tri] = 0.0  # an all-zero row
    want = jinv.compress_grids(jinv.TransportGrids(**{k: jnp.asarray(v) for k, v in
                                                      arrays.items()}), n_tri)
    got = compress_grids(TransportGrids(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                         n_tri)
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_compress_semantics():
    """tests/test_inverse.py:103: log, factor-normalise, row-normalise."""
    nt, b = 2, 6
    w_sum = torch.tensor([np.e - 1, 0.0, 0.0, 0.0, np.e**2 - 1, np.e**2 - 1], dtype=torch.float32)
    factors = torch.zeros(b, 2)
    factors[0, 0], factors[4, 0], factors[5, 0] = 2.0, 1.0, 1.0
    pixel = torch.zeros(b, 2, 3)
    pixel[0, 0] = torch.tensor([4.0, 2.0, 0.0])
    w, pix, _ = compress_grids(TransportGrids(w_sum, pixel, torch.zeros(b, 2, 3), factors,
                                              torch.zeros(b)), nt)
    torch.testing.assert_close(w, torch.tensor([[1.0, 0.0], [0.0, 0.0], [0.5, 0.5]]),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(pix[0, 0], torch.tensor([2.0, 1.0, 0.0]), rtol=0, atol=1e-6)
    assert not torch.isnan(pix).any()


def test_extract_graph_drive():
    """A small CPU extraction of scene 0 against a flat-coloured target:
    shapes, no NaN, rows summing to 1, the floor and back wall seen from the
    eye, light only on the emitters' columns (tests/test_inverse.py)."""
    ts = port_scene(jipt.load_scene(SCENE0, asset_root=ASSET_ROOT))
    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=6, tile_size=512)
    img = torch.full((16, 16, 3), 0.5)
    w, pixel, light = extract_graph(ts, img, 1, cfg, **CPU)
    nt = ts.n_tri
    assert w.shape == (nt + 1, nt) and pixel.shape == light.shape == (nt + 1, nt, 3)
    assert not any(torch.isnan(t).any() for t in (w, pixel, light))
    sums = w.sum(dim=1)
    torch.testing.assert_close(sums[sums > 0], torch.ones_like(sums[sums > 0]), rtol=1e-5,
                               atol=0)
    assert w[-1, 0] > 0 and w[-1, 10] > 0 and int((w[-1] > 0).sum()) >= 15
    torch.testing.assert_close(pixel[-1, 10], torch.full((3,), 0.5), rtol=1e-5, atol=0)
    assert float(light[:, 16:18].sum()) > 0 and float(light.max()) <= 10.0 + 1e-4
    assert float(light[:, :16].abs().max()) == 0.0 and float(light[:, 18:].abs().max()) == 0.0

"""The port's forward render as a whole, on the CPU.

  * External RNG: JAX's own camera rays and bounce uniforms (per JAX tile,
    _pallas_uniforms) through the port against JAX render_samples
    (backend="xla") over several tiles: radiance rtol 1e-4 / atol 1e-5,
    segment and shadow-ray counts equal, and the tone-mapped images equal to
    rtol 1e-5.
  * Fused RNG: bit-identical under any tile size, deterministic per seed.
  * Ground truth: artifacts/bench_golden_0.png (500x500, 100 spp, reference
    cube Kd) box-resized to 100x100 against the port at 100x100/32 spp:
    mean |d| < 6/255 and channel means within 3/255 (the JAX XLA path
    measures 4.95/255 here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.render import forward as jfwd

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import (
    ASSET_ROOT,
    REFERENCE_CUBE_KD,
    RenderConfig,
    load_scene,
    render_image,
    render_range,
    render_samples,
    render_to_png,
    scene_from_numpy,
)
from inverse_path_tracer_torch.render.forward import camera_rays_from_jitter
from inverse_path_tracer_torch.scene.build import build_scene
from inverse_path_tracer_torch.scene.dsl import ObjectParams
from inverse_path_tracer_torch.utils.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
GOLDEN_PNG = os.path.join(REPO, "artifacts", "bench_golden_0.png")
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def scenes():
    js = jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    return js, scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})


def jax_rays_and_uniforms(js, jcfg, key):
    """Exactly the rays and (bounces*8, n) uniforms each JAX XLA tile uses."""
    n, tile = jcfg.n_samples, jcfg.tile_size
    ps, ds, us = [], [], []
    for start in range(0, n, tile):
        idx = start + jnp.arange(tile, dtype=jnp.int32)
        tkey = jax.random.fold_in(key, start // tile)
        p, d = jfwd.camera_rays(js, jcfg, tkey, idx)
        ps.append(np.asarray(p))
        ds.append(np.asarray(d))
        us.append(np.asarray(jfwd._pallas_uniforms(tkey, jcfg, tile)))
    return (torch.from_numpy(np.concatenate(ps)[:n]), torch.from_numpy(np.concatenate(ds)[:n]),
            torch.from_numpy(np.concatenate(us, axis=1)[:, :n]))


@pytest.mark.parametrize("quirks", [True, False])
def test_external_rng_matches_jax_xla(scenes, quirks):
    js, ts = scenes
    shape = dict(width=8, height=6, spp=5, max_bounces=6, reference_quirks=quirks)
    jcfg = jipt.RenderConfig(tile_size=128, backend="xla", **shape)  # 240 samples: 2 JAX tiles
    key = jax.random.PRNGKey(21)
    want, want_st = jfwd.render_samples(js.diffuse, js, key, jcfg)
    p, d, u = jax_rays_and_uniforms(js, jcfg, key)
    tcfg = RenderConfig(tile_size=100, rng="external", **shape)  # 3 port launches
    got, got_st = render_samples(ts.diffuse, ts, 0, tcfg, rays=(p, d), uniforms=u, **CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert int(got_st.segments) == int(want_st.segments)
    assert int(got_st.shadow_rays) == int(want_st.shadow_rays)
    img = render_image(ts.diffuse, ts, 0, tcfg, rays=(p, d), uniforms=u, **CPU)
    assert img.shape == (6, 8, 3)
    np.testing.assert_allclose(
        img.numpy(), np.asarray(jfwd.render_image(js.diffuse, js, key, jcfg)), rtol=1e-5, atol=1e-6)


def test_camera_rays_match_jax(scenes):
    js, ts = scenes
    jcfg = jipt.RenderConfig(width=7, height=5, spp=3)
    idx = np.arange(jcfg.n_samples, dtype=np.int32)
    g = np.random.default_rng(0)
    u1, u2 = g.random(idx.size).astype(np.float32), g.random(idx.size).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = jfwd.camera_rays(js, jcfg, key, jnp.asarray(idx))  # jitter from JAX's key
    ju1 = np.array(jfwd._u(key, 0, jfwd._SLOT_JITTER_X, idx.size))
    ju2 = np.array(jfwd._u(key, 0, jfwd._SLOT_JITTER_Y, idx.size))
    cfg = RenderConfig(width=7, height=5, spp=3)
    p, d = camera_rays_from_jitter(ts, cfg, torch.from_numpy(idx).long(),
                                   torch.from_numpy(ju1), torch.from_numpy(ju2))
    np.testing.assert_allclose(d.numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-7)
    assert not p.any()
    # The orange left wall (x = -2) shows on the image's right: x-mirror
    # camera.  Sample 18 lies in column 6, the rightmost.
    _, d2 = camera_rays_from_jitter(ts, cfg, torch.tensor([18]), torch.tensor([u1[0]]),
                                    torch.tensor([u2[0]]))
    assert d2[0, 0] < 0


def test_fused_rng_is_tiling_invariant_and_deterministic(scenes):
    _, ts = scenes
    cfg = RenderConfig(width=6, height=5, spp=4, max_bounces=5)
    a, sa = render_samples(ts.diffuse, ts, 3, cfg.with_(tile_size=1 << 20), **CPU)
    b, sb = render_samples(ts.diffuse, ts, 3, cfg.with_(tile_size=7), **CPU)
    assert torch.equal(a, b)
    assert int(sa.segments) == int(sb.segments) and int(sa.shadow_rays) == int(sb.shadow_rays)
    # A render split into ranges is the same render.
    lo, _ = render_range(ts.diffuse, ts, 3, cfg, 0, 50, **CPU)
    hi, _ = render_range(ts.diffuse, ts, 3, cfg, 50, cfg.n_samples - 50, **CPU)
    assert torch.equal(torch.cat([lo, hi]), a)
    again, _ = render_samples(ts.diffuse, ts, 3, cfg, **CPU)
    other, _ = render_samples(ts.diffuse, ts, 4, cfg, **CPU)
    assert torch.equal(again, a)
    assert not torch.equal(other, a)
    assert sa.segments.dtype == torch.int64


def test_range_past_the_end_is_dead(scenes):
    _, ts = scenes
    cfg = RenderConfig(width=4, height=4, spp=2, max_bounces=4)
    vals, st = render_range(ts.diffuse, ts, 1, cfg, cfg.n_samples - 5, 10, **CPU)
    assert vals.shape == (10, 3) and not vals[5:].any()
    full, _ = render_samples(ts.diffuse, ts, 1, cfg, **CPU)
    assert torch.equal(vals[:5], full[-5:])


def test_emissive_free_scene_renders_black():
    scene = build_scene([ObjectParams(pos=(0, -1.5, 4), obj_file="shapes/cube.obj",
                                      mtl_file="*Kd 0.5 0.5 0.5*")], asset_root=ASSET_ROOT)
    assert scene.n_emissive == 0
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=4)
    vals, st = render_samples(scene.diffuse, scene, 0, cfg, **CPU)
    assert not vals.any()
    assert int(st.shadow_rays) == 0 and int(st.segments) > 0


def test_matches_golden_image(tmp_path):
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    mats = scene.diffuse.clone()
    mats[18:] = torch.tensor(REFERENCE_CUBE_KD)
    cfg = RenderConfig(width=100, height=100, spp=32, max_bounces=16, tile_size=1 << 16)
    out = tmp_path / "ours.png"
    img8 = render_to_png(mats, scene, 1, cfg, str(out), **CPU)
    assert torch.equal(torch.from_numpy(read_png(str(out))), img8)
    ref = read_png(GOLDEN_PNG).astype(np.float32)
    # Box resize 500 -> 100 (PIL's BOX filter: 5x5 means, rounded to uint8).
    ref = np.floor(ref.reshape(100, 5, 100, 5, 3).mean(axis=(1, 3)) + 0.5)
    ours = img8.numpy().astype(np.float32)
    assert np.abs(ref - ours).mean() < 6.0
    np.testing.assert_array_less(np.abs(ref.mean(axis=(0, 1)) - ours.mean(axis=(0, 1))), 3.0)


def test_device_none_means_cuda(monkeypatch, scenes):
    _, ts = scenes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(width=2, height=2, spp=1, max_bounces=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_samples(ts.diffuse, ts, 0, cfg)


def test_config_and_backend_errors(scenes):
    _, ts = scenes
    with pytest.raises(ValueError, match="backend"):
        RenderConfig(backend="pallas")
    with pytest.raises(ValueError, match="rng"):
        RenderConfig(rng="auto")
    cfg = RenderConfig(width=2, height=2, spp=1, max_bounces=2)
    with pytest.raises(ValueError, match="external"):
        render_samples(ts.diffuse, ts, 0, cfg.with_(rng="external"), **CPU)
    plain, _ = render_samples(ts.diffuse, ts, 0, cfg.with_(backend="plain"), **CPU)
    auto, _ = render_samples(ts.diffuse, ts, 0, cfg, **CPU)
    assert torch.equal(plain, auto)

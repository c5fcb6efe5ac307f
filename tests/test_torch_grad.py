"""The port's material gradient on the CPU.

  * External RNG: autograd through the port's render_samples (the
    autograd Function around render_range, whose backward is grad_tile's
    plain version here) against jax.grad of the JAX render_samples on the
    XLA path with plain AD (backend="xla", grad_mode="ad"), on JAX's own
    rays and uniforms, with a non-uniform cotangent: both quirk modes and
    the specular scene, rtol 2e-4 / atol 1e-7 (tests/test_diff.py's
    tolerance between the analytic VJP and AD).
  * The Function against torch autograd through render_tile_plain, and
    against central finite differences (tests/test_diff.py:53-67).
  * The fused-RNG gradient does not depend on the launch size (rtol 1e-6).
  * loss_and_grad_range (records forward + reverse) against autograd of
    render_range, rtol 1e-6 (tests/test_pallas.py:148-176's contract).
"""

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
    RenderConfig,
    grad_range,
    loss_and_grad_range,
    render_range,
    render_samples,
    scene_from_numpy,
)
from inverse_path_tracer_torch.ops.kernels.render_kernel import render_tile_plain
from inverse_path_tracer_torch.render.forward import camera_rays
from test_torch_forward import SCENE0, jax_rays_and_uniforms
from test_torch_render_kernel import jax_scene

CPU = dict(device="cpu")


def to_port(js):
    return scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})


@pytest.fixture(scope="module")
def scenes():
    js = jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    return js, to_port(js)


def weights(n, seed=9):
    return np.random.default_rng(seed).random((n, 3)).astype(np.float32)


@pytest.mark.parametrize("kind,quirks", [("cornell", True), ("cornell", False),
                                         ("specular", True)])
def test_grad_matches_jax_ad_external_rng(kind, quirks, tmp_path):
    js = jax_scene(kind, tmp_path)
    ts = to_port(js)
    shape = dict(width=8, height=6, spp=4, max_bounces=6, reference_quirks=quirks)
    jcfg = jipt.RenderConfig(tile_size=96, backend="xla", grad_mode="ad", **shape)
    key = jax.random.PRNGKey(17)
    w = weights(jcfg.n_samples)

    def jloss(m):
        vals, _ = jfwd.render_samples(m, js, key, jcfg)
        return jnp.sum(vals * w)

    want = np.asarray(jax.grad(jloss)(js.diffuse))
    p, d, u = jax_rays_and_uniforms(js, jcfg, key)
    tcfg = RenderConfig(tile_size=80, rng="external", **shape)  # 3 port launches
    m = ts.diffuse.clone().requires_grad_()
    vals, _ = render_samples(m, ts, 0, tcfg, rays=(p, d), uniforms=u, **CPU)
    (vals * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), want, rtol=2e-4, atol=1e-7)
    assert np.abs(want).sum() > 0 and np.count_nonzero(want) > 30
    # grad_range is the same backward, called directly.
    direct = grad_range(ts.diffuse, ts, 0, tcfg, 0, tcfg.n_samples, torch.from_numpy(w),
                        rays=(p, d), uniforms=u, **CPU)
    torch.testing.assert_close(direct, m.grad, rtol=0, atol=0)


@pytest.mark.parametrize("quirks", [True, False])
def test_function_matches_autograd_through_plain_loop(scenes, quirks):
    _, ts = scenes
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=6, tile_size=100,
                       reference_quirks=quirks)
    n = cfg.n_samples
    w = torch.from_numpy(weights(n, seed=2))
    m = ts.diffuse.clone().requires_grad_()
    vals, _ = render_range(m, ts, 3, cfg, 0, n, **CPU)
    (vals * w).sum().backward()

    m2 = ts.diffuse.clone().requires_grad_()
    idx = torch.arange(n)
    p, d = camera_rays(ts, cfg, 3, idx)
    from inverse_path_tracer_torch.ops import rng

    rad, _ = render_tile_plain(m2, ts, cfg, p.T.contiguous(), d.T.contiguous(),
                               torch.ones((1, n)), orig=idx.int()[None].contiguous(),
                               keys=rng.key_words(3))
    torch.testing.assert_close(rad.T.detach(), vals, rtol=0, atol=0)
    (rad.T * w).sum().backward()
    torch.testing.assert_close(m.grad, m2.grad, rtol=1e-5, atol=1e-7)


def test_grad_finite_differences(scenes):
    _, ts = scenes
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=4, tile_size=128)

    def loss(mats):
        vals, _ = render_samples(mats, ts, 7, cfg, **CPU)
        return (vals**2).mean()

    m = ts.diffuse.clone().requires_grad_()
    loss(m).backward()
    g = m.grad.numpy()
    eps = 1e-3
    with torch.no_grad():
        for tri, ch in [(0, 0), (10, 1), (18, 2), (29, 0)]:
            mp, mm = ts.diffuse.clone(), ts.diffuse.clone()
            mp[tri, ch] += eps
            mm[tri, ch] -= eps
            fd = (float(loss(mp)) - float(loss(mm))) / (2 * eps)
            assert abs(fd - g[tri, ch]) <= 2e-3 * max(1.0, abs(fd)), (tri, ch, fd, g[tri, ch])
    assert np.abs(g).sum() > 0


def test_fused_grad_is_launch_size_invariant(scenes):
    _, ts = scenes
    cfg = RenderConfig(width=6, height=5, spp=4, max_bounces=5)
    w = torch.from_numpy(weights(cfg.n_samples, seed=4))
    grads = []
    for tile in (1 << 20, 7):
        m = ts.diffuse.clone().requires_grad_()
        vals, _ = render_samples(m, ts, 5, cfg.with_(tile_size=tile), **CPU)
        (vals * w).sum().backward()
        grads.append(m.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-9)
    assert grads[0].abs().sum() > 0


@pytest.mark.parametrize("rng_mode", ["fused", "external"])
def test_loss_and_grad_range_matches_autograd(scenes, rng_mode):
    js, ts = scenes
    cfg = RenderConfig(width=16, height=8, spp=4, max_bounces=6, tile_size=192, rng=rng_mode)
    n = cfg.n_samples  # 512 samples: launches of 192, 192, 128
    kw = dict(CPU)
    if rng_mode == "external":
        jcfg = jipt.RenderConfig(width=16, height=8, spp=4, max_bounces=6, tile_size=n)
        p, d, u = jax_rays_and_uniforms(js, jcfg, jax.random.PRNGKey(8))
        kw.update(rays=(p, d), uniforms=u)
    w = torch.from_numpy(weights(n, seed=6))

    def tile_post(vals, start):
        return (vals * w[start : start + vals.shape[0]]).sum() * 1e-3

    loss, d_mats, stats = loss_and_grad_range(ts.diffuse, ts, 8, cfg, 0, n, tile_post, **kw)

    m = ts.diffuse.clone().requires_grad_()
    vals, ref_stats = render_range(m, ts, 8, cfg, 0, n, **kw)
    total = sum(tile_post(vals[lo : lo + 192], lo) for lo in range(0, n, 192))
    total.backward()
    torch.testing.assert_close(d_mats, m.grad, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(loss, total.detach(), rtol=1e-6, atol=0)
    assert int(stats.segments) == int(ref_stats.segments)
    assert int(stats.shadow_rays) == int(ref_stats.shadow_rays)
    with pytest.raises(ValueError, match="multiple of spp"):
        loss_and_grad_range(ts.diffuse, ts, 8, cfg.with_(tile_size=190), 0, n, tile_post, **kw)


def test_render_without_grad_and_device_none(scenes, monkeypatch):
    _, ts = scenes
    cfg = RenderConfig(width=4, height=4, spp=2, max_bounces=3)
    vals, _ = render_samples(ts.diffuse, ts, 1, cfg, **CPU)
    assert not vals.requires_grad
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grad_range(ts.diffuse, ts, 0, cfg, 0, cfg.n_samples, torch.ones(cfg.n_samples, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loss_and_grad_range(ts.diffuse, ts, 0, cfg, 0, cfg.n_samples, lambda v, s: v.sum())

"""Tests of the port that need the card.  They skip without a CUDA device.

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has no JAX (tests/conftest.py imports it, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: radiance and records rtol 1e-4 / atol 1e-5 and equal ray
counts, kernel against its plain version on the same inputs; the material
gradient rtol 1e-4 with an absolute floor of 1e-6 of its largest entry (the
kernels and the plain one-hot contraction sum in different orders).
"""

import os

import pytest
import torch

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, load_scene, render_samples
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    grad_tile,
    grad_tile_plain,
    render_tile,
    render_tile_plain,
    render_tile_rec,
    render_tile_rec_plain,
    reverse_tile,
    reverse_tile_plain,
)
from inverse_path_tracer_torch.render.forward import camera_rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
RTOL, ATOL = 1e-4, 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture()
def scene0(card):
    return load_scene(SCENE0, asset_root=ASSET_ROOT).to(card)


def tile_args(scene, cfg, card, mode):
    n = cfg.n_samples
    idx = torch.arange(n, device=card)
    p, d = camera_rays(scene, cfg, 5, idx)
    args = dict(p=p.T.contiguous(), d=d.T.contiguous(),
                alive=torch.ones((1, n), device=card),
                orig=idx.to(torch.int32)[None, :].contiguous())
    if mode == "external":
        g = torch.Generator(device="cpu").manual_seed(1)
        args["uniforms"] = torch.rand((cfg.max_bounces * 8, n), generator=g).to(card)
    else:
        args["keys"] = rng.key_words(5)
    return args


def assert_grad_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("mode", ["external", "fused"])
def test_kernel_matches_plain(card, scene0, mode, quirks):
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8, reference_quirks=quirks)
    args = tile_args(scene0, cfg, card, mode)
    before = render_tile.launches
    rk, sk = render_tile(scene0.diffuse, scene0, cfg, **args)
    rp, sp = render_tile_plain(scene0.diffuse, scene0, cfg, **args)
    assert render_tile.launches == before + 1
    torch.testing.assert_close(rk, rp, rtol=RTOL, atol=ATOL)
    assert torch.equal(sk, sp)


def test_render_samples_goes_through_the_kernel(card, scene0):
    cfg = RenderConfig(width=16, height=16, spp=8, max_bounces=6, tile_size=700)
    before = render_tile.launches
    vals, st = render_samples(scene0.diffuse, scene0, 2, cfg)  # device=None: the card
    assert render_tile.launches == before + 3  # 2048 samples in launches of 700
    assert vals.device.type == "cuda" and torch.isfinite(vals).all()
    plain, pst = render_samples(scene0.diffuse, scene0, 2, cfg.with_(backend="plain"))
    torch.testing.assert_close(vals, plain, rtol=RTOL, atol=ATOL)
    assert int(st.segments) == int(pst.segments) and int(st.shadow_rays) == int(pst.shadow_rays)


def test_emitter_free_scene_and_dead_lanes(card):
    """No emitters: black, no shadow rays.  A range past the last sample:
    the dead lanes stay zero and the live ones equal the full render."""
    from inverse_path_tracer_torch import build_scene, render_range
    from inverse_path_tracer_torch.scene.dsl import ObjectParams

    cube = build_scene([ObjectParams(pos=(0, -1.5, 4), obj_file="shapes/cube.obj",
                                     mtl_file="*Kd 0.5 0.5 0.5*")], asset_root=ASSET_ROOT)
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=4)
    vals, st = render_samples(cube.diffuse, cube, 0, cfg)
    assert not vals.any() and int(st.shadow_rays) == 0 and int(st.segments) > 0

    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    full, _ = render_samples(scene.diffuse, scene, 4, cfg)
    tail, _ = render_range(scene.diffuse, scene, 4, cfg, cfg.n_samples - 100, 300)
    assert not tail[100:].any()
    torch.testing.assert_close(tail[:100], full[-100:], rtol=0, atol=0)


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("mode", ["external", "fused"])
def test_gradient_kernels_match_plain(card, scene0, mode, quirks):
    """B3's radiance and counts are B1's; its records, B2 and B4 match their
    plain versions; B4 on B3's records gives B2's gradient."""
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8, reference_quirks=quirks)
    args = tile_args(scene0, cfg, card, mode)
    g = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(2)).to(card)
    mats = scene0.diffuse
    before = (render_tile_rec.launches, grad_tile.launches, reverse_tile.launches)
    rad, st, rec = render_tile_rec(mats, scene0, cfg, **args)
    d_b2 = grad_tile(mats, scene0, cfg, g=g, **args)
    d_b4 = reverse_tile(scene0.n_tri, cfg, rec, g)
    assert (render_tile_rec.launches, grad_tile.launches, reverse_tile.launches) == tuple(
        k + 1 for k in before)
    rad1, st1 = render_tile(mats, scene0, cfg, **args)
    assert torch.equal(rad, rad1) and torch.equal(st, st1)
    _, _, rec_p = render_tile_rec_plain(mats, scene0, cfg, **args)
    torch.testing.assert_close(rec, rec_p, rtol=RTOL, atol=ATOL)
    assert_grad_close(d_b2, grad_tile_plain(mats, scene0, cfg, g=g, **args))
    assert_grad_close(d_b4, reverse_tile_plain(scene0.n_tri, cfg, rec, g))
    torch.testing.assert_close(d_b4, d_b2, rtol=1e-6, atol=0)
    assert bool(torch.isfinite(d_b2).all()) and float(d_b2.abs().sum()) > 0


def test_backward_goes_through_render_bwd(card, scene0):
    from inverse_path_tracer_torch import loss_and_grad_range
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    cfg = RenderConfig(width=16, height=16, spp=8, max_bounces=6, tile_size=1024)
    n = cfg.n_samples
    grads = {}
    for backend in ("auto", "plain"):
        m = scene0.diffuse.clone().requires_grad_()
        before = (render_tile.launches, grad_tile.launches)
        vals, _ = render_samples(m, scene0, 2, cfg.with_(backend=backend))
        tonemap_mean(vals, cfg.spp).mean().backward()
        launched = (render_tile.launches - before[0], grad_tile.launches - before[1])
        assert launched == ((2, 2) if backend == "auto" else (0, 0))
        grads[backend] = m.grad
    assert_grad_close(grads["auto"], grads["plain"])

    before = (render_tile_rec.launches, reverse_tile.launches)
    loss, d_mats, _ = loss_and_grad_range(
        scene0.diffuse, scene0, 2, cfg, 0, n,
        lambda v, lo: tonemap_mean(v, cfg.spp).sum() / (n // cfg.spp * 3))
    assert (render_tile_rec.launches - before[0], reverse_tile.launches - before[1]) == (2, 2)
    torch.testing.assert_close(d_mats, grads["auto"], rtol=1e-5, atol=1e-9)

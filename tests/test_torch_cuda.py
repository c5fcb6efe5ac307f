"""Tests of the port that need the card.  They skip without a CUDA device.

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has no JAX (tests/conftest.py imports it, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: radiance rtol 1e-4 / atol 1e-5 and equal ray counts, kernel
against its plain version on the same inputs.
"""

import os

import pytest
import torch

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, load_scene, render_samples
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels.render_kernel import render_tile, render_tile_plain
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


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("mode", ["external", "fused"])
def test_kernel_matches_plain(card, scene0, mode, quirks):
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8, reference_quirks=quirks)
    n = cfg.n_samples
    idx = torch.arange(n, device=card)
    p, d = camera_rays(scene0, cfg, 5, idx)
    args = dict(p=p.T.contiguous(), d=d.T.contiguous(),
                alive=torch.ones((1, n), device=card),
                orig=idx.to(torch.int32)[None, :].contiguous())
    if mode == "external":
        g = torch.Generator(device="cpu").manual_seed(1)
        args["uniforms"] = torch.rand((cfg.max_bounces * 8, n), generator=g).to(card)
    else:
        args["keys"] = rng.key_words(5)
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

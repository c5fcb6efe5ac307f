"""Batched material recovery in the port (models/recover.py
recover_materials_batched, batched_step) on the CPU.

  * One batched step of S = 2 scenes against the JAX package's
    jax.value_and_grad(recover_loss) per scene (XLA path, plain AD), on
    JAX's rays and uniforms of every scene and key; with n_keys = 2 the mean
    over the keys.  Tolerance: value rtol 1e-5, gradient rtol 2e-4 / atol
    1e-7 (as tests/test_torch_recover.py).
  * scene_chunk, checkpoint/resume (also inside the Polyak window) and the
    single-scene step's n_keys change no bit of the result.
  * init_materials starts theta at logit(clip(init)); the loss falls over
    10 steps (the analogue of tests/test_workflow.py:50).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.models import recover as jrec

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import (
    ASSET_ROOT,
    RenderConfig,
    load_scene,
    recover_materials_batched,
    render_image,
    scene_from_numpy,
)
from inverse_path_tracer_torch.models.recover import batched_step, make_optimizer, recover_step
from inverse_path_tracer_torch.ops import rng
from test_torch_forward import SCENE0, jax_rays_and_uniforms

CPU = dict(device="cpu")
SMALL = RenderConfig(width=8, height=8, spp=2, max_bounces=3, tile_size=128)


@pytest.fixture(scope="module")
def scenes():
    js = jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    return js, scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})


@pytest.fixture(scope="module")
def targets4():
    """Four targets of scene 0 at SMALL, the Kd scaled per scene."""
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    return torch.stack([render_image(scene.diffuse * f, scene, 9, SMALL, **CPU)
                        for f in (1.0, 0.5, 0.8, 0.2)])


@pytest.mark.parametrize("n_keys", [1, 2])
def test_batched_step_matches_jax_per_scene(scenes, n_keys):
    js, ts = scenes
    shape = dict(width=8, height=8, spp=4, max_bounces=5)
    jcfg = jipt.RenderConfig(tile_size=128, backend="xla", grad_mode="ad", **shape)
    g = np.random.default_rng(3)
    theta = g.normal(0.0, 0.5, (2,) + js.diffuse.shape).astype(np.float32)
    targets = (g.random((2, 8, 8, 3)) * 0.5).astype(np.float32)
    jkeys = [[jax.random.PRNGKey(10 * j + k + 1) for k in range(n_keys)] for j in range(2)]
    feeds = [[jax_rays_and_uniforms(js, jcfg, jkeys[j][k]) for k in range(n_keys)]
             for j in range(2)]

    th = torch.tensor(theta, requires_grad=True)  # a copy: the step writes into it
    opt = make_optimizer(th, 0.1)
    losses = batched_step(th, opt, ts, [0, 1], RenderConfig(rng="external", tile_size=100, **shape),
                          torch.from_numpy(targets), n_keys=n_keys,
                          inputs=lambda j, k: dict(rays=feeds[j][k][:2], uniforms=feeds[j][k][2]),
                          **CPU)
    assert losses.shape == (2,)
    for j in range(2):
        vg = [jax.value_and_grad(jrec.recover_loss)(jnp.asarray(theta[j]), js, jkeys[j][k], jcfg,
                                                    jnp.asarray(targets[j]))
              for k in range(n_keys)]
        want = np.mean([float(v) for v, _ in vg])
        want_g = np.mean([np.asarray(gr) for _, gr in vg], axis=0)
        np.testing.assert_allclose(float(losses[j]), want, rtol=1e-5)
        np.testing.assert_allclose(th.grad[j].numpy(), want_g, rtol=2e-4, atol=1e-7)
        assert np.abs(want_g).sum() > 0
    assert not np.array_equal(th.detach().numpy(), theta)  # the step was taken


@pytest.fixture(scope="module")
def unchunked(targets4):
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    return recover_materials_batched(scene, targets4, SMALL, steps=3, lr=0.1, key=5, **CPU)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_scene_chunk_is_bit_identical(targets4, unchunked, chunk):
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    mats, losses = recover_materials_batched(scene, targets4, SMALL, steps=3, lr=0.1, key=5,
                                             scene_chunk=chunk, **CPU)
    assert mats.shape == (4, 30, 3)
    assert torch.equal(mats, unchunked[0])
    assert losses == unchunked[1]


def test_resume_is_bit_identical(targets4, tmp_path):
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    tg = targets4[:2]
    ckpt = str(tmp_path / "batch.npz")
    run = lambda steps, **kw: recover_materials_batched(scene, tg, SMALL, steps=steps, lr=0.1,
                                                        key=7, **kw, **CPU)
    full, full_losses = run(6)
    run(3, checkpoint_path=ckpt, checkpoint_every=3)
    assert not os.path.exists(ckpt + ".avg")
    resumed, losses = run(6, checkpoint_path=ckpt, resume=True)
    assert torch.equal(resumed, full)
    assert losses == full_losses[3:]


def test_resume_inside_the_averaging_window_is_bit_identical(targets4, tmp_path):
    """The run of 8 steps averages steps 3..7.  A run killed right after its
    checkpoint at step 6 holds steps 3..5 in its Polyak sum, which the
    stand-in short run (6 steps, average_last 3) writes; the resume reloads
    it because step 6 lies inside the window."""
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    tg = targets4[:2]
    ckpt = str(tmp_path / "avg.npz")
    run = lambda steps, **kw: recover_materials_batched(scene, tg, SMALL, steps=steps, lr=0.1,
                                                        key=7, **kw, **CPU)
    full, _ = run(8, average_last=5)
    last, _ = run(8)
    assert not torch.equal(full, last)  # the average is not the last iterate
    run(6, average_last=3, checkpoint_path=ckpt, checkpoint_every=3)
    assert os.path.exists(ckpt + ".avg")
    resumed, losses = run(8, average_last=5, checkpoint_path=ckpt, resume=True)
    assert len(losses) == 2
    assert torch.equal(resumed, full)


def test_init_materials_start_theta(targets4):
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    init = np.random.default_rng(4).random((2, 30, 3)).astype(np.float32)
    init[0, 0] = (0.0, 1.0, 0.5)  # clipped to 1e-4 and 1 - 1e-4
    mats, losses = recover_materials_batched(scene, targets4[:2], SMALL, steps=0,
                                             init_materials=init, **CPU)
    assert losses == []
    np.testing.assert_allclose(mats.numpy(), np.clip(init, 1e-4, 1 - 1e-4), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="init_materials"):
        recover_materials_batched(scene, targets4[:2], SMALL, steps=1, init_materials=init[:1],
                                  **CPU)


def test_recover_step_n_keys_is_the_batched_step_of_one_scene(targets4):
    """The single-scene step with n_keys = 2 takes the keys fold_in(key, k)
    and the mean gradient, as the batched step does for each scene."""
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    theta0 = torch.from_numpy(np.random.default_rng(6).normal(0, 0.5, (30, 3)).astype(np.float32))
    a = theta0.clone().requires_grad_()
    loss = recover_step(a, make_optimizer(a, 0.1), scene, 11, SMALL, targets4[0], n_keys=2, **CPU)
    b = theta0[None].clone().requires_grad_()
    losses = batched_step(b, make_optimizer(b, 0.1), scene, [11], SMALL, targets4[:1], n_keys=2,
                          **CPU)
    assert loss == float(losses[0])
    assert torch.equal(a.grad, b.grad[0]) and torch.equal(a.detach(), b.detach()[0])
    one = theta0.clone().requires_grad_()
    recover_step(one, make_optimizer(one, 0.1), scene, rng.fold_in(11, 0), SMALL, targets4[0],
                 **CPU)
    assert not torch.equal(one.grad, a.grad)  # two keys are not one


def test_batched_recovery_lowers_the_loss():
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=3, tile_size=256)
    targets = torch.stack([render_image(scene.diffuse * f, scene, 0, cfg, **CPU)
                           for f in (1.0, 0.5)])
    mats, losses = recover_materials_batched(scene, targets, cfg, steps=10, lr=0.1, **CPU)
    assert mats.shape == (2, 30, 3)
    assert len(losses) == 10
    assert losses[-1] < losses[0]


def test_batched_recovery_device_none_needs_cuda(monkeypatch):
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recover_materials_batched(scene, torch.zeros(1, 2, 2, 3),
                                  RenderConfig(width=2, height=2, spp=1), steps=1)

"""Material recovery in the port (models/recover.py) on the CPU.

  * recover_loss and its gradient against the JAX package's recover_loss
    (XLA path, plain AD) on JAX's rays and uniforms: value rtol 1e-5,
    gradient rtol 2e-4 / atol 1e-7.
  * One Adam step from a carried-over optimizer state against optax.adam:
    rtol 1e-5 (4e-5 at an early step, see the test).
  * recover_materials moves Kd toward the labels (the criteria of
    tests/test_utils.py:52-71, at 24x24, 4 spp, 4 bounces).
  * Checkpoint/resume is bit-identical, and checkpoints round-trip and are
    replaced atomically.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.models import recover as jrec

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import (
    ASSET_ROOT,
    RenderConfig,
    load_scene,
    recover_materials,
    render_image,
    scene_from_numpy,
)
from inverse_path_tracer_torch.convert import adam_state_from_numpy
from inverse_path_tracer_torch.models.recover import make_optimizer, recover_loss
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from test_torch_forward import SCENE0, jax_rays_and_uniforms

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def scenes():
    js = jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    return js, scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})


def test_recover_loss_and_grad_match_jax(scenes):
    js, ts = scenes
    shape = dict(width=8, height=8, spp=4, max_bounces=5)
    jcfg = jipt.RenderConfig(tile_size=128, backend="xla", grad_mode="ad", **shape)
    key = jax.random.PRNGKey(4)
    g = np.random.default_rng(1)
    theta = g.normal(0.0, 0.5, js.diffuse.shape).astype(np.float32)
    target = g.random((8, 8, 3)).astype(np.float32) * 0.5
    want, want_g = jax.value_and_grad(jrec.recover_loss)(jnp.asarray(theta), js, key, jcfg,
                                                          jnp.asarray(target))
    p, d, u = jax_rays_and_uniforms(js, jcfg, key)
    th = torch.from_numpy(theta).requires_grad_()
    loss = recover_loss(th, ts, 0, RenderConfig(rng="external", tile_size=100, **shape),
                        torch.from_numpy(target), rays=(p, d), uniforms=u, **CPU)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_g), rtol=2e-4, atol=1e-7)
    assert np.abs(np.asarray(want_g)).sum() > 0


@pytest.mark.parametrize("count,rtol", [(1000, 1e-5), (3, 4e-5)])
def test_adam_step_matches_optax(count, rtol):
    """One step from the same carried-over (mu, nu, count): the updates
    agree to rtol 1e-5 at count 1000.  optax computes the bias correction
    1 - b2**(count+1) in float32 from float32(0.999), torch in float64 from
    0.999; at count 3 that correction is 0.004 and optax's keeps ~4.5
    digits, so there the updates agree to rtol 4e-5."""
    g = np.random.default_rng(2)
    theta, grad, mu, r = (g.normal(size=(30, 3)).astype(np.float32) for _ in range(4))
    mu = 0.1 * mu
    nu = mu * mu + 0.01 * r * r + 1e-4  # a second moment consistent with the first
    opt = optax.adam(0.1)
    state = opt.init(jnp.asarray(theta))
    state = (state[0]._replace(count=jnp.asarray(count, jnp.int32), mu=jnp.asarray(mu),
                               nu=jnp.asarray(nu)),) + tuple(state[1:])
    want, _ = opt.update(jnp.asarray(grad), state)

    th = torch.from_numpy(theta.copy()).requires_grad_()
    t_opt = make_optimizer(th, 0.1)
    t_opt.state[th] = adam_state_from_numpy(mu, nu, count)
    th.grad = torch.from_numpy(grad)
    t_opt.step()
    np.testing.assert_allclose(th.detach().numpy() - theta, np.asarray(want), rtol=rtol,
                               atol=1e-7)
    assert float(t_opt.state[th]["step"]) == count + 1
    assert np.abs(np.asarray(want)).mean() > 1e-2  # a real step was taken


def test_recover_moves_kd_toward_labels():
    """At 4 spp the Kd-error ratio after 30 steps depends on the seeds of
    the target and of the steps: 0.63-0.78 (mean 0.69) over 22 seed pairs
    of the port, 0.61-0.73 (mean 0.68) over 12 of the JAX package, whose
    own test fixes its seeds too.  So the seeds are fixed here; chip_smoke.py
    checks the same criteria at 64x64/8 spp/8 bounces."""
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    cfg = RenderConfig(width=24, height=24, spp=4, max_bounces=4, tile_size=768)
    target = render_image(scene.diffuse, scene, 4, cfg, **CPU)
    mats, losses = recover_materials(scene, target, cfg, steps=30, lr=0.1, key=43, **CPU)
    assert len(losses) == 30
    assert losses[-1] < losses[0] * 0.75
    err0 = float((0.5 - scene.diffuse).abs().mean())  # sigmoid(0) = 0.5 start
    err = float((mats - scene.diffuse).abs().mean())
    assert err < err0 * 0.7, (err, err0)


def test_recover_checkpoint_resume_is_bit_identical(tmp_path):
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=3, tile_size=512)
    target = torch.full((16, 16, 3), 0.3)
    ckpt = str(tmp_path / "rec.npz")
    full, _ = recover_materials(scene, target, cfg, steps=12, lr=0.1, key=3, **CPU)
    recover_materials(scene, target, cfg, steps=6, lr=0.1, key=3, checkpoint_path=ckpt,
                      checkpoint_every=6, **CPU)
    resumed, losses = recover_materials(scene, target, cfg, steps=12, lr=0.1, key=3,
                                        checkpoint_path=ckpt, resume=True, **CPU)
    assert len(losses) == 6  # only steps 6..11 ran
    assert torch.equal(resumed, full)
    other, _ = recover_materials(scene, target, cfg, steps=12, lr=0.1, key=4, **CPU)
    assert not torch.equal(other, full)


def test_step_keys_are_a_pure_function_of_seed_and_step():
    assert rng.fold_in(3, 7) == rng.fold_in(3, 7)
    keys = {rng.fold_in(s, i) for s in (0, 1, 2**40) for i in range(50)}
    assert len(keys) == 150
    assert all(0 <= k < 2**64 for k in keys)


def test_checkpoint_roundtrip_and_atomic_overwrite(tmp_path):
    path = str(tmp_path / "c" / "ckpt.npz")
    save_checkpoint(path, {"a": torch.arange(6.0).reshape(2, 3), "b": np.ones(4)}, step=42,
                    note="x")
    arrays, step = load_checkpoint(path)
    assert step == 42 and sorted(arrays) == ["a", "b"]
    assert torch.equal(arrays["a"], torch.arange(6.0).reshape(2, 3))
    save_checkpoint(path, {"a": torch.zeros(3)}, step=43)
    arrays, step = load_checkpoint(path)
    assert step == 43 and torch.equal(arrays["a"], torch.zeros(3))
    assert not os.path.exists(path + ".tmp")
    with pytest.raises(ValueError, match="reserved"):
        save_checkpoint(path, {"__meta__": torch.zeros(1)})


def test_recover_device_none_needs_cuda(monkeypatch):
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recover_materials(scene, torch.zeros(2, 2, 3), RenderConfig(width=2, height=2, spp=1),
                          steps=1)

"""Direct gradient-based material recovery on one device (the counterpart of
the JAX package's models/recover.py, single-chip and batched paths).

Recovery minimises

    loss(theta) = mean |tonemap(render(sigmoid(theta))) - target|

over the (nT, 3) parameter theta with Adam (optax's defaults: b1 0.9, b2
0.999, eps 1e-8).  The gradient is the renderer's analytic one: on the card
B1 forward and B2 backward (render_range under autograd).
recover_materials_batched steps S scenes that share geometry, each with its
own (nT, 3) rows of a (S, nT, 3) theta, its own target and its own keys.
With mesh= (parallel/shard.py make_mesh) both split each render's rays over
the ranks of a process group and all-reduce the loss and the gradient
before the step (the JAX package's make_batched_step(mesh=) and
recover_materials(mesh=)).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, List, Optional, Tuple

import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.convert import adam_state_from_numpy
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.tonemap import tonemap_mean
from inverse_path_tracer_torch.parallel.shard import batched_step_sharded, make_recover_step
from inverse_path_tracer_torch.render.forward import render_samples, resolve_device
from inverse_path_tracer_torch.scene.build import SceneData
from inverse_path_tracer_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from inverse_path_tracer_torch.utils.profiling import span, spanned


def recover_loss(
    theta: torch.Tensor,
    scene: SceneData,
    key: int,
    cfg: RenderConfig,
    target01: torch.Tensor,
    **kw,
) -> torch.Tensor:
    """Mean absolute difference between the tone-mapped render of
    sigmoid(theta) and target01 (H, W, 3).  `kw` goes to render_samples
    (device, and rays/uniforms with rng="external")."""
    mats = torch.sigmoid(theta)
    vals, _ = render_samples(mats, scene, key, cfg, **kw)
    with span("ipt.recover.loss"):
        img = tonemap_mean(vals, cfg.spp).reshape(cfg.height, cfg.width, 3)
        return (img - target01.to(img.device)).abs().mean()


def make_optimizer(theta: torch.Tensor, lr: float) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (eps outside the square root), pinned
    to the single-tensor implementation on every device, so that chunked,
    resumed and uninterrupted runs take the same arithmetic."""
    return torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=False)


def keyed_loss(theta, scene, key, cfg, target01, n_keys: int = 1,
               inputs: Optional[Callable[[int], dict]] = None, **kw) -> torch.Tensor:
    """recover_loss under `key`; with n_keys > 1 the mean of the losses under
    rng.fold_in(key, k) for k < n_keys (JAX make_single_chip_step_fn), whose
    gradient is the mean of theirs.  `inputs(k)` gives render k's extra
    keyword arguments (rays and uniforms with rng="external")."""
    extra = (lambda k: {}) if inputs is None else inputs
    if n_keys <= 1:
        return recover_loss(theta, scene, key, cfg, target01, **extra(0), **kw)
    return torch.stack([recover_loss(theta, scene, rng.fold_in(key, k), cfg, target01,
                                     **extra(k), **kw) for k in range(n_keys)]).mean()


@spanned("ipt.recover.step")
def recover_step(theta, opt, scene, key, cfg, target01, n_keys: int = 1, **kw) -> float:
    """One optimizer step on theta; returns the loss before the step."""
    with span("ipt.recover.optim"):
        opt.zero_grad(set_to_none=True)
    loss = keyed_loss(theta, scene, key, cfg, target01, n_keys, **kw)
    with span("ipt.recover.backward"):
        loss.backward()
    with span("ipt.recover.optim"):
        opt.step()
    return float(loss.detach())


@spanned("ipt.recover.step")
def batched_step(theta, opt, scene, keys, cfg, targets01, n_keys: int = 1,
                 scene_chunk: int = 0,
                 inputs: Optional[Callable[[int, int], dict]] = None, **kw) -> torch.Tensor:
    """One optimizer step on theta (S, nT, 3): scene j's loss is keyed_loss
    of theta[j] under keys[j] against targets01[j], and theta[j] receives
    its gradient alone.  The scenes go in groups of scene_chunk (all S at
    0), each group rendered and backpropagated before the next, so that at
    most one group's autograd graphs are alive; one Adam step follows.
    Groups change no bit of the result.  `inputs(j, k)` gives scene j's
    render k's extra keyword arguments.  Returns the (S,) losses before the
    step; theta.grad keeps the step's gradient."""
    s = theta.shape[0]
    c = scene_chunk if 0 < scene_chunk < s else s
    with span("ipt.recover.optim"):
        opt.zero_grad(set_to_none=True)
    losses = []
    for a in range(0, s, c):
        part = [keyed_loss(theta[j], scene, keys[j], cfg, targets01[j], n_keys,
                           None if inputs is None else functools.partial(inputs, j), **kw)
                for j in range(a, min(a + c, s))]
        with span("ipt.recover.backward"):
            torch.stack(part).sum().backward()
        losses += [loss.detach() for loss in part]
    with span("ipt.recover.optim"):
        opt.step()
    return torch.stack(losses)


def _save_state(path, theta, opt, step):
    st = opt.state[theta]
    save_checkpoint(path, {"theta": theta, "exp_avg": st["exp_avg"],
                           "exp_avg_sq": st["exp_avg_sq"], "step": st["step"]}, step=step)


def _load_state(path, theta, opt, device) -> int:
    """Load a _save_state checkpoint into theta and opt; returns its step."""
    saved, step = load_checkpoint(path)
    with torch.no_grad():
        theta.copy_(saved["theta"])
    if "exp_avg" in saved:
        opt.state[theta] = adam_state_from_numpy(
            saved["exp_avg"].numpy(), saved["exp_avg_sq"].numpy(), int(saved["step"]),
            device=device)
    return step


def recover_materials(
    scene: SceneData,
    target01: torch.Tensor,
    cfg: RenderConfig,
    steps: int = 200,
    lr: float = 5e-2,
    key: int = 0,
    log_fn: Optional[Callable[[int, float], None]] = None,
    resample_every: int = 1,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    device=None,
    mesh=None,
) -> Tuple[torch.Tensor, List[float]]:
    """Recover per-triangle Kd for one scene against a target image (H, W,
    3) in [0, 1).  theta starts at 0 (Kd = 0.5).  With a mesh each step is
    parallel/shard.py's sharded step on the mesh's device (`device` is not
    read).

    Step i renders with the key rng.fold_in(key, i - i % resample_every): a
    fresh Monte-Carlo sample set every `resample_every` steps, as a pure
    function of (key, step).  Every `checkpoint_every` steps (theta, Adam's
    state) are written atomically to checkpoint_path; with resume=True a run
    continues from the saved step, and the result is bit-identical to an
    uninterrupted run.

    Returns (sigmoid(theta) (nT, 3), the loss of every step run)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    scene = scene.to(dev)
    theta = torch.zeros_like(scene.diffuse, dtype=torch.float32, device=dev, requires_grad=True)
    opt = make_optimizer(theta, lr)
    start_step = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        start_step = _load_state(checkpoint_path, theta, opt, dev)
    if mesh is not None:
        sharded = make_recover_step(scene, cfg, mesh, opt)
    r = max(resample_every, 1)
    losses: List[float] = []
    for i in range(start_step, steps):
        step_key = rng.fold_in(key, i - i % r)
        if mesh is not None:
            losses.append(sharded(theta, step_key, target01))
        else:
            losses.append(recover_step(theta, opt, scene, step_key, cfg, target01, device=dev))
        if log_fn is not None:
            log_fn(i, losses[-1])
        if checkpoint_path and checkpoint_every and (i + 1) % checkpoint_every == 0:
            _save_state(checkpoint_path, theta, opt, i + 1)
    return torch.sigmoid(theta.detach()), losses


def recover_materials_batched(
    scene: SceneData,
    targets01: torch.Tensor,
    cfg: RenderConfig,
    steps: int = 200,
    lr: float = 5e-2,
    key: int = 0,
    log_fn: Optional[Callable[[int, float], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    n_keys: int = 1,
    average_last: int = 0,
    init_materials=None,
    scene_chunk: int = 0,
    device=None,
    mesh=None,
) -> Tuple[torch.Tensor, List[float]]:
    """Recover per-triangle Kd for S scenes that share `scene`'s geometry and
    differ in their materials (the reference's 100 scenes differ only in
    the cube's Kd), against targets01 (S, H, W, 3) in [0, 1).

    theta (S, nT, 3) starts at 0 (Kd = 0.5), or at
    logit(clip(init_materials, 1e-4, 1 - 1e-4)) for init_materials (S, nT,
    3) in (0, 1), e.g. the GCN's predictions.  Scene j of step i renders
    under rng.fold_in(rng.fold_in(key, i), j) (n_keys > 1: the mean over
    keys k of fold_in of that key, k), and one Adam over theta steps every
    scene at once: the same arithmetic as S Adams, all at the same step.
    scene_chunk: see batched_step.

    average_last = K > 0 returns the mean of sigmoid(theta) over the last K
    steps (Polyak), in place of the last iterate.  Every checkpoint_every
    steps (theta, Adam's state) go to checkpoint_path, in recover_materials'
    format, and the running Polyak sum and its count to checkpoint_path +
    ".avg"; with resume=True a run continues from the saved step, reloading
    the sum when the saved step lies inside the averaging window, and the
    result is bit-identical to an uninterrupted run.

    With a mesh (parallel/shard.py make_mesh) each scene's rays are split
    over its ranks on the mesh's device (`device` is not read), and the
    step is parallel/shard.py batched_step_sharded.  As in the JAX package,
    whose sharded batched step takes one key per scene (it passes no
    n_keys to make_recover_step_fn), n_keys is not read then: scene j of
    step i renders under the one key above.

    Returns (materials (S, nT, 3), the mean loss over scenes of every step
    run)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    scene = scene.to(dev)
    targets01 = torch.as_tensor(targets01).to(device=dev, dtype=torch.float32)
    s = targets01.shape[0]
    if init_materials is not None:
        m0 = torch.as_tensor(init_materials).to(device=dev, dtype=torch.float32)
        m0 = torch.clamp(m0, 1e-4, 1.0 - 1e-4)
        theta0 = torch.log(m0) - torch.log1p(-m0)
    else:
        theta0 = torch.zeros((s,) + tuple(scene.diffuse.shape), dtype=torch.float32, device=dev)
    if theta0.shape != (s, scene.n_tri, 3):
        raise ValueError(f"init_materials must be {(s, scene.n_tri, 3)}, got "
                         f"{tuple(theta0.shape)}")
    theta = theta0.requires_grad_()
    opt = make_optimizer(theta, lr)
    start_step = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        start_step = _load_state(checkpoint_path, theta, opt, dev)
    avg, n_avg = None, 0
    avg_path = checkpoint_path + ".avg" if checkpoint_path else None
    if (resume and average_last and avg_path and os.path.exists(avg_path)
            and start_step > steps - average_last):
        saved, _ = load_checkpoint(avg_path)
        avg, n_avg = saved["avg"].to(dev), int(saved["n_avg"])
    losses: List[float] = []
    for i in range(start_step, steps):
        step_key = rng.fold_in(key, i)
        keys = [rng.fold_in(step_key, j) for j in range(s)]
        if mesh is not None:
            step_losses = batched_step_sharded(theta, opt, scene, keys, cfg, targets01, mesh,
                                               scene_chunk)
        else:
            step_losses = batched_step(theta, opt, scene, keys, cfg, targets01, n_keys,
                                       scene_chunk, device=dev)
        losses.append(float(step_losses.mean()))
        if average_last and i >= steps - average_last:
            m = torch.sigmoid(theta.detach())
            avg = m if avg is None else avg + m  # JAX's order of the sum
            n_avg += 1
        if log_fn is not None:
            log_fn(i, losses[-1])
        if checkpoint_path and checkpoint_every and (i + 1) % checkpoint_every == 0:
            _save_state(checkpoint_path, theta, opt, i + 1)
            if average_last and avg is not None:
                save_checkpoint(avg_path, {"avg": avg, "n_avg": torch.tensor(n_avg)}, step=i + 1)
    if avg is not None and n_avg > 0:
        return avg / n_avg, losses
    return torch.sigmoid(theta.detach()), losses

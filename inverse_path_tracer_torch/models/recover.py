"""Direct gradient-based material recovery on one device (the counterpart of
the JAX package's models/recover.py, single-chip path).

Recovery minimises

    loss(theta) = mean |tonemap(render(sigmoid(theta))) - target|

over the (nT, 3) parameter theta with Adam (optax's defaults: b1 0.9, b2
0.999, eps 1e-8).  The gradient is the renderer's analytic one: on the card
B1 forward and B2 backward (render_range under autograd).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.convert import adam_state_from_numpy
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.tonemap import tonemap_mean
from inverse_path_tracer_torch.render.forward import render_samples, resolve_device
from inverse_path_tracer_torch.scene.build import SceneData
from inverse_path_tracer_torch.utils.checkpoint import load_checkpoint, save_checkpoint


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
    img = tonemap_mean(vals, cfg.spp).reshape(cfg.height, cfg.width, 3)
    return (img - target01.to(img.device)).abs().mean()


def make_optimizer(theta: torch.Tensor, lr: float) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (eps outside the square root)."""
    return torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def recover_step(theta, opt, scene, key, cfg, target01, **kw) -> float:
    """One optimizer step on theta; returns the loss before the step."""
    opt.zero_grad(set_to_none=True)
    loss = recover_loss(theta, scene, key, cfg, target01, **kw)
    loss.backward()
    opt.step()
    return float(loss.detach())


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
) -> Tuple[torch.Tensor, List[float]]:
    """Recover per-triangle Kd for one scene against a target image (H, W,
    3) in [0, 1).  theta starts at 0 (Kd = 0.5).

    Step i renders with the key rng.fold_in(key, i - i % resample_every): a
    fresh Monte-Carlo sample set every `resample_every` steps, as a pure
    function of (key, step).  Every `checkpoint_every` steps (theta, Adam's
    state) are written atomically to checkpoint_path; with resume=True a run
    continues from the saved step, and the result is bit-identical to an
    uninterrupted run.

    Returns (sigmoid(theta) (nT, 3), the loss of every step run)."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    theta = torch.zeros_like(scene.diffuse, dtype=torch.float32, device=dev, requires_grad=True)
    opt = make_optimizer(theta, lr)
    start_step = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        saved, start_step = load_checkpoint(checkpoint_path)
        with torch.no_grad():
            theta.copy_(saved["theta"])
        if "exp_avg" in saved:
            opt.state[theta] = adam_state_from_numpy(
                saved["exp_avg"].numpy(), saved["exp_avg_sq"].numpy(), int(saved["step"]),
                device=dev)
    r = max(resample_every, 1)
    losses: List[float] = []
    for i in range(start_step, steps):
        step_key = rng.fold_in(key, i - i % r)
        losses.append(recover_step(theta, opt, scene, step_key, cfg, target01, device=dev))
        if log_fn is not None:
            log_fn(i, losses[-1])
        if checkpoint_path and checkpoint_every and (i + 1) % checkpoint_every == 0:
            st = opt.state[theta]
            save_checkpoint(checkpoint_path, {"theta": theta, "exp_avg": st["exp_avg"],
                                              "exp_avg_sq": st["exp_avg_sq"],
                                              "step": st["step"]}, step=i + 1)
    return torch.sigmoid(theta.detach()), losses

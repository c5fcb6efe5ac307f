"""Rays split over the ranks of a torch.distributed process group (the
counterpart of the JAX package's parallel/shard.py).

The sample axis is split into equal contiguous shares, one per rank; the
scene and the (nT, 3) materials (or the recovery's theta) are replicated.
The only collectives are the gather of the radiance, the sums of the ray
counts, and the all-reduce of a recovery step's loss and gradient.  The
split is the JAX package's (_per_device_count), so both packages give a
rank the same samples.

Each rank renders its share with render_range(start=rank * share,
count=share); lanes past the last sample are dead.  Every random number is
keyed by the global sample index (render/forward.py), whatever
cfg.tile_size is, so the N-rank radiance and counts equal one rank's bit
for bit.  A recovery step's loss and gradient are sums of the ranks'
partial sums, added in another order than one rank adds them; after the
all-reduce they are the same bits on every rank, and so is theta after the
optimizer step.

Collectives run on the mesh's backend: NCCL on the tensors' device; gloo
through CPU copies (gloo cannot all-gather CUDA tensors), which is how two
ranks that share one card exchange data (parallel/multihost.py
choose_backend).  Without a process group a mesh has one rank and its
collectives are identities; a group of one rank runs them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.ops.tonemap import tonemap_mean
from inverse_path_tracer_torch.render.forward import RenderStats, render_range, resolve_device
from inverse_path_tracer_torch.scene.build import SceneData


class TileRNGInvariantWarning(UserWarning):
    """Kept for the JAX package's name; never raised here.  In the JAX
    package a tile_size above a device's sample count changed the tile RNG
    keys, so its N-chip render was not the 1-chip render.  The port keys
    every random number by the global sample index, not by the tile, so
    the N-rank render is bit-identical to one rank's at any tile_size
    (tests/test_torch_shard.py holds it)."""


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that share a render: this process's rank, their number,
    the device this rank computes on and the collective backend (None
    without a process group)."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None

    def _via_cpu(self) -> bool:
        return self.backend == "gloo" and self.device.type != "cpu"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of `t` (every rank gets the same bits)."""
        if self.backend is None:
            return t
        if self._via_cpu():
            host = t.detach().cpu()
            dist.all_reduce(host)
            return host.to(self.device)
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' `t` (same shape on each) concatenated along dim 0 in
        rank order."""
        if self.backend is None:
            return t
        if self.backend == "gloo":
            host = t.detach().cpu().contiguous()
            parts = [torch.empty_like(host) for _ in range(self.size)]
            dist.all_gather(parts, host)
            return torch.cat(parts).to(self.device)
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.detach().contiguous())
        return out


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the process group's ranks (parallel/multihost.py
    init_distributed).  Without a process group: one rank on `device`
    (None means CUDA and raises without a card).  A rank's device is
    cuda:(rank % device_count) unless given.  n_devices, where given, must
    be the number of ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process group "
                             "(parallel/multihost.py init_distributed)")
        return Mesh(0, 1, resolve_device(device))
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"the process group has {size} ranks, not {n_devices}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(device)
    backend = dist.get_backend()
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs CUDA tensors, not {dev}")
        torch.cuda.set_device(dev)
    return Mesh(rank, size, dev, backend)


def _per_device_count(cfg: RenderConfig, n_dev: int) -> int:
    """Samples per rank (JAX parallel/shard.py:74-86): the total padded up so
    that each rank's share is whole pixels (a multiple of spp), then up to
    a multiple of min(tile_size, share)."""
    total = cfg.n_samples
    quantum = cfg.spp * n_dev
    padded = -(-total // quantum) * quantum
    per_dev = padded // n_dev
    tile = min(cfg.tile_size, per_dev)
    if per_dev % tile:
        per_dev = -(-per_dev // tile) * tile
    return per_dev


def _share(x: Optional[torch.Tensor], lo: int, count: int, dim: int) -> Optional[torch.Tensor]:
    """x[lo:lo+count] along `dim`, zero-padded past its end (None stays
    None)."""
    if x is None:
        return None
    part = x.narrow(dim, min(lo, x.shape[dim]), max(0, min(count, x.shape[dim] - lo)))
    pad = count - part.shape[dim]
    if pad:
        shape = list(part.shape)
        shape[dim] = pad
        part = torch.cat([part, part.new_zeros(shape)], dim=dim)
    return part


def _rank_inputs(cfg, mesh: Mesh, rays, uniforms) -> Tuple[int, int, dict]:
    """(start, count, render_range's keyword arguments) of this rank's
    share; whole-image rays (n_samples, 3) and uniforms (bounces*8,
    n_samples) are sliced to it."""
    per_dev = _per_device_count(cfg, mesh.size)
    start = mesh.rank * per_dev
    kw = dict(device=mesh.device)
    if rays is not None:
        kw["rays"] = tuple(_share(r, start, per_dev, 0) for r in rays)
    if uniforms is not None:
        kw["uniforms"] = _share(uniforms, start, per_dev, 1)
    return start, per_dev, kw


def render_samples_sharded(
    materials: torch.Tensor,
    scene: SceneData,
    key: int,
    cfg: RenderConfig,
    mesh: Mesh,
    *,
    rays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, RenderStats]:
    """render_samples with the samples split over the mesh: (n_samples, 3)
    radiance gathered on every rank and the summed RenderStats, both equal
    to render_samples' bit for bit.  With cfg.rng="external", rays and
    uniforms are the whole image's."""
    start, count, kw = _rank_inputs(cfg, mesh, rays, uniforms)
    with torch.no_grad():
        vals, stats = render_range(materials, scene, key, cfg, start, count, **kw)
    counts = mesh.all_reduce(torch.stack([stats.segments, stats.shadow_rays]))
    out = mesh.all_gather(vals)[: cfg.n_samples]
    return out, RenderStats(segments=counts[0], shadow_rays=counts[1])


def render_image_sharded(materials, scene, key, cfg, mesh, **kw) -> torch.Tensor:
    """Tone-mapped (H, W, 3) image of render_samples_sharded."""
    samples, _ = render_samples_sharded(materials, scene, key, cfg, mesh, **kw)
    return tonemap_mean(samples, cfg.spp).reshape(cfg.height, cfg.width, 3)


def local_loss(theta: torch.Tensor, scene: SceneData, key: int, cfg: RenderConfig, mesh: Mesh,
               target01: torch.Tensor, rays=None, uniforms=None) -> torch.Tensor:
    """This rank's part of the recovery loss mean |tonemap(render(sigmoid(
    theta))) - target|: sum(|tonemap(its share) - its target rows| * valid)
    / (W*H*3), differentiable in theta; the ranks' parts sum to the loss.
    Rows past the last pixel are masked out.  (The JAX package takes the
    target rows with a dynamic_slice, which clamps the start, so a share
    that ends past the image reads misaligned rows; the rows here are the
    share's own.)"""
    start, count, kw = _rank_inputs(cfg, mesh, rays, uniforms)
    vals, _ = render_range(torch.sigmoid(theta), scene, key, cfg, start, count, **kw)
    img = tonemap_mean(vals, cfg.spp)
    n_pix = cfg.width * cfg.height
    pix0 = start // cfg.spp
    target_flat = target01.to(device=mesh.device, dtype=torch.float32).reshape(-1, 3)
    tgt = _share(target_flat, pix0, img.shape[0], 0)
    valid = (torch.arange(pix0, pix0 + img.shape[0], device=mesh.device) < n_pix)[:, None]
    return torch.sum(torch.abs(img - tgt) * valid) / float(n_pix * 3)


def make_recover_step_fn(scene: SceneData, cfg: RenderConfig, mesh: Mesh,
                         optimizer: torch.optim.Optimizer) -> Callable:
    """The sharded recovery step (JAX parallel/shard.py:131-209): theta are
    the (nT, 3) logits that `optimizer` steps (Kd = sigmoid(theta)); each
    rank renders its share, backpropagates its local_loss into theta.grad,
    all-reduces the loss and the gradient, and steps the optimizer, so
    that the replicated theta stays bit-identical on every rank.

    Returns step(theta, key, target01, rays=None, uniforms=None) -> the
    loss before the step (a float); theta.grad keeps the step's gradient."""
    def step(theta, key, target01, rays=None, uniforms=None) -> float:
        optimizer.zero_grad(set_to_none=True)
        loss = local_loss(theta, scene, key, cfg, mesh, target01, rays, uniforms)
        loss.backward()
        theta.grad = mesh.all_reduce(theta.grad)
        optimizer.step()
        return float(mesh.all_reduce(loss.detach()))

    return step


# PyTorch runs eagerly: the JAX package's jitted wrapper is the same step.
make_recover_step = make_recover_step_fn


def batched_step_sharded(theta, opt, scene, keys: List[int], cfg, targets01, mesh: Mesh,
                         scene_chunk: int = 0) -> torch.Tensor:
    """One optimizer step on theta (S, nT, 3) with each scene's rays split
    over the mesh: scene j's local_loss under keys[j] against targets01[j],
    scenes in groups of scene_chunk backpropagated in turn (as
    models/recover.py batched_step), then one all-reduce of the gradient
    and one of the (S,) losses, and the step.  Returns the losses before
    the step."""
    s = theta.shape[0]
    c = scene_chunk if 0 < scene_chunk < s else s
    opt.zero_grad(set_to_none=True)
    losses = []
    for a in range(0, s, c):
        part = [local_loss(theta[j], scene, keys[j], cfg, mesh, targets01[j])
                for j in range(a, min(a + c, s))]
        torch.stack(part).sum().backward()
        losses += [loss.detach() for loss in part]
    theta.grad = mesh.all_reduce(theta.grad)
    opt.step()
    return mesh.all_reduce(torch.stack(losses))

"""Forward Monte-Carlo path tracer with next-event estimation.

The per-bounce math is the JAX package's (render/forward.py), including the
reference quirks, active when cfg.reference_quirks (the default):

  (Q1) first-hit emission L_e is never cleared and is re-added at every
       bounce, scaled by the running throughput;
  (Q2) an escaping ray still adds prev_mult * (L_e + L_d) with the stale
       L_d of the previous bounce;
  (Q3) cosine-sampled diffuse directions carry pdf 1/pi;
  (Q4) the NEE weight divides by the light's selection probability only.

With reference_quirks=False, (Q1) adds emission once and (Q2) adds nothing.

Entry points take device=None, meaning "cuda", and raise when CUDA is not
available; the CPU runs only when asked for (device="cpu").  Rays run in
launches of cfg.tile_size samples through ops/kernels/render_kernel
(the CUDA kernels on the card, their plain versions on the CPU or with
cfg.backend="plain"): render_range through B1 forward and B2 backward
under autograd, loss_and_grad_range through B3 and B4.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    grad_tile,
    grad_tile_plain,
    pack_tables,
    render_tile,
    render_tile_plain,
    render_tile_rec,
    render_tile_rec_plain,
    reverse_tile,
    reverse_tile_plain,
)
from inverse_path_tracer_torch.ops.tonemap import tonemap_mean, tonemap_to_uint8
from inverse_path_tracer_torch.scene.build import SceneData
from inverse_path_tracer_torch.utils.png import write_png


class RenderStats(NamedTuple):
    """Ray accounting for rays/s (int64 scalars: a float32 running sum
    loses counts at 512x512x64 spp x 16 bounces)."""

    segments: torch.Tensor  # path segments traced (alive lanes per bounce)
    shadow_rays: torch.Tensor  # NEE shadow rays traced (hit lanes per bounce)


def resolve_device(device=None) -> torch.device:
    """device=None means CUDA; raise rather than run somewhere else."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def camera_rays_from_jitter(
    scene: SceneData, cfg: RenderConfig, sample_idx: torch.Tensor,
    u1: torch.Tensor, u2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays (n, 3) for global sample indices (r*W + c)*spp + s with
    pixel jitter (u1, u2) (reference path_trace.cu:155-165): x = 2(c+u1)/W -
    1, y = 1 - 2(r+u2)/H, d = normalize(x, y, 1) @ M33^T normalized, origin
    0 (the eye translation is dropped, scene/build.py)."""
    r = (sample_idx // (cfg.spp * cfg.width)).to(torch.float32)
    c = ((sample_idx // cfg.spp) % cfg.width).to(torch.float32)
    x = 2.0 * (c + u1) / cfg.width - 1.0
    y = 1.0 - 2.0 * (r + u2) / cfg.height
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d @ scene.cam_m33.T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.zeros_like(d), d


def camera_rays(
    scene: SceneData, cfg: RenderConfig, key: int, sample_idx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays with the jitter of the counter-hash RNG (bounce 0,
    slots 6 and 7 of each sample's stream)."""
    h = rng.hash_orig(rng.key_words(key), sample_idx)
    u = rng.draw(rng.key_words(key), h, 0, (rng.SLOT_JITTER_X, rng.SLOT_JITTER_Y))
    return camera_rays_from_jitter(scene, cfg, sample_idx, u[0], u[1])


class _Kernels(NamedTuple):
    """The per-launch functions of one range: the forward (B1), the forward
    with records (B3), the fused backward (B2) and the reverse on records
    (B4), or their plain versions."""

    fwd: Callable
    fwd_rec: Callable
    grad: Callable
    reverse: Callable


def _kernels(cfg: RenderConfig, scene: SceneData, materials: torch.Tensor) -> _Kernels:
    """cfg.backend="plain" takes the plain versions on any device; otherwise
    the wrappers (the kernels on the card, the plain versions on the CPU),
    with the kernel's tables packed once per range, not once per launch."""
    if cfg.backend == "plain":
        return _Kernels(render_tile_plain, render_tile_rec_plain, grad_tile_plain,
                        reverse_tile_plain)
    tables = pack_tables(scene, materials) if scene.device.type == "cuda" else None
    with_tables = lambda fn: functools.partial(fn, tables=tables)
    return _Kernels(with_tables(render_tile), with_tables(render_tile_rec),
                    with_tables(grad_tile), reverse_tile)


class _External(NamedTuple):
    """Caller-supplied rays and uniforms of a whole range (rng="external")."""

    p: torch.Tensor  # (count, 3)
    d: torch.Tensor  # (count, 3)
    uniforms: torch.Tensor  # (max_bounces*8, count)


def _prepare(materials, scene, cfg, count, rays, uniforms, device):
    """The device, the scene and materials on it (materials stay attached
    to autograd) and, with rng="external", the checked rays and uniforms."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    materials = materials.to(device=dev, dtype=torch.float32)
    if cfg.rng != "external":
        if rays is not None or uniforms is not None:
            raise ValueError("rays/uniforms are only read with rng='external'")
        return dev, scene, materials, None
    if rays is None or uniforms is None:
        raise ValueError("rng='external' needs rays=(p, d) and uniforms")
    p_all, d_all = (r.to(device=dev, dtype=torch.float32) for r in rays)
    u_all = uniforms.to(device=dev, dtype=torch.float32)
    if p_all.shape != (count, 3) or d_all.shape != (count, 3):
        raise ValueError(f"rays must be (count, 3) = ({count}, 3)")
    if u_all.shape != (cfg.max_bounces * 8, count):
        raise ValueError(f"uniforms must be ({cfg.max_bounces * 8}, {count})")
    return dev, scene, materials, _External(p_all, d_all, u_all)


def _launches(scene, cfg, key, start, count, ext: Optional[_External]):
    """(lo, hi, kernel inputs) of each launch of cfg.tile_size samples.  The
    backward rebuilds exactly the forward's rays from the same key and
    global indices (or slices the same external rays and uniforms)."""
    dev = scene.device
    keys = None if ext is not None else rng.key_words(key)
    tile = max(1, min(cfg.tile_size, count))
    for lo in range(0, count, tile):
        hi = min(lo + tile, count)
        idx = torch.arange(start + lo, start + hi, dtype=torch.int64, device=dev)
        alive = (idx < cfg.n_samples).to(torch.float32)[None, :]
        if ext is not None:
            p, d = ext.p[lo:hi], ext.d[lo:hi]
            u = ext.uniforms[:, lo:hi].contiguous()
        else:
            p, d = camera_rays(scene, cfg, key, idx)
            u = None
        yield lo, hi, dict(p=p.T.contiguous(), d=d.T.contiguous(), alive=alive, uniforms=u,
                           orig=idx.to(torch.int32)[None, :].contiguous(), keys=keys)


def _grad_launches(materials, scene, key, cfg, start, count, g_vals, ext) -> torch.Tensor:
    kern = _kernels(cfg, scene, materials)
    d_mats = torch.zeros((scene.n_tri, 3), dtype=torch.float32, device=scene.device)
    for lo, hi, a in _launches(scene, cfg, key, start, count, ext):
        d_mats = d_mats + kern.grad(materials, scene, cfg, g=g_vals[lo:hi].T.contiguous(), **a)
    return d_mats


class _RenderRange(torch.autograd.Function):
    """render_range with the material gradient of the kernels (the
    counterpart of _render_range_pallas and its defvjp, JAX
    render/forward.py:1091-1127): the forward runs B1 per launch, the
    backward B2 per launch on the forward's rays."""

    @staticmethod
    def forward(ctx, materials, scene, key, cfg, start, count, ext):
        kern = _kernels(cfg, scene, materials)
        out = torch.empty((count, 3), dtype=torch.float32, device=scene.device)
        totals = torch.zeros(2, dtype=torch.float64, device=scene.device)
        for lo, hi, a in _launches(scene, cfg, key, start, count, ext):
            rad, stats = kern.fwd(materials, scene, cfg, **a)
            out[lo:hi] = rad.T
            totals += stats.sum(dim=1, dtype=torch.float64)
        counts = totals.to(torch.int64)
        ctx.mark_non_differentiable(counts)
        ctx.save_for_backward(materials)
        ctx.range = (scene, key, cfg, start, count, ext)
        return out, counts

    @staticmethod
    def backward(ctx, g_vals, _g_counts):
        (materials,) = ctx.saved_tensors
        scene, key, cfg, start, count, ext = ctx.range
        d_mats = _grad_launches(materials, scene, key, cfg, start, count,
                                g_vals.to(torch.float32), ext)
        return d_mats, None, None, None, None, None, None


def render_range(
    materials: torch.Tensor,
    scene: SceneData,
    key: int,
    cfg: RenderConfig,
    start: int,
    count: int,
    *,
    rays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, RenderStats]:
    """Radiance (count, 3) for the global sample indices start..start+count,
    differentiable in `materials` (the backward is grad_range).

    cfg.rng="fused": rays and uniforms come from the counter hash of `key`
    and the global sample index, so the result does not depend on
    cfg.tile_size or on how a render is split into ranges.
    cfg.rng="external": `rays` = (p, d), each (count, 3), and `uniforms`
    (max_bounces*8, count) are supplied by the caller; `key` is unused."""
    _, scene, materials, ext = _prepare(materials, scene, cfg, count, rays, uniforms, device)
    out, counts = _RenderRange.apply(materials, scene, key, cfg, start, count, ext)
    return out, RenderStats(segments=counts[0], shadow_rays=counts[1])


def grad_range(
    materials: torch.Tensor,
    scene: SceneData,
    key: int,
    cfg: RenderConfig,
    start: int,
    count: int,
    g_vals: torch.Tensor,
    *,
    rays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """d(sum g_vals * radiance)/d materials (nT, 3) for the range of
    render_range, through B2 per launch (the counterpart of
    _grad_range_pallas, JAX render/forward.py:902-958).  g_vals is (count,
    3)."""
    dev, scene, materials, ext = _prepare(materials, scene, cfg, count, rays, uniforms, device)
    if tuple(g_vals.shape) != (count, 3):
        raise ValueError(f"g_vals must be ({count}, 3), got {tuple(g_vals.shape)}")
    g_vals = g_vals.to(device=dev, dtype=torch.float32)
    return _grad_launches(materials.detach(), scene, key, cfg, start, count, g_vals, ext)


def loss_and_grad_range(
    materials: torch.Tensor,
    scene: SceneData,
    key: int,
    cfg: RenderConfig,
    start: int,
    count: int,
    tile_post: Callable[[torch.Tensor, int], torch.Tensor],
    *,
    rays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, RenderStats]:
    """A scalar loss and its material gradient over a sample range, the
    training path of the JAX package's loss_and_grad_range
    (render/forward.py:961-1079, its non-staged branch).

    tile_post(vals (n, 3), launch_start) -> the scalar loss of one launch of
    n <= cfg.tile_size consecutive samples starting at global index
    launch_start; the launches' losses are summed.  Lanes past the last
    sample render as zeros.  Per launch, B3 renders and writes its records,
    autograd differentiates tile_post, and B4 turns the records and that
    cotangent into the (nT, 3) gradient, with no replay of the bounce loop.
    Like JAX this needs whole pixels per launch: cfg.tile_size (when it is
    below count) a multiple of cfg.spp.  The gradient equals that of
    render_range under autograd.

    Returns (loss, d_materials (nT, 3), stats)."""
    tile = max(1, min(cfg.tile_size, count))
    if tile < count and tile % cfg.spp:
        raise ValueError(f"tile_size {cfg.tile_size} must be a multiple of spp {cfg.spp}")
    _, scene, materials, ext = _prepare(materials, scene, cfg, count, rays, uniforms, device)
    materials = materials.detach()
    kern = _kernels(cfg, scene, materials)
    dev = scene.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    d_mats = torch.zeros((scene.n_tri, 3), dtype=torch.float32, device=dev)
    totals = torch.zeros(2, dtype=torch.float64, device=dev)
    for lo, _hi, a in _launches(scene, cfg, key, start, count, ext):
        rad, stats, rec = kern.fwd_rec(materials, scene, cfg, **a)
        vals = rad.T.detach().requires_grad_()
        with torch.enable_grad():
            lt = tile_post(vals, start + lo)
        (g,) = torch.autograd.grad(lt, vals, allow_unused=True, materialize_grads=True)
        d_mats = d_mats + kern.reverse(scene.n_tri, cfg, rec, g.T.contiguous())
        loss = loss + lt.detach()
        totals += stats.sum(dim=1, dtype=torch.float64)
    counts = totals.to(torch.int64)
    return loss, d_mats, RenderStats(segments=counts[0], shadow_rays=counts[1])


def render_samples(
    materials: torch.Tensor, scene: SceneData, key: int, cfg: RenderConfig, **kw
) -> Tuple[torch.Tensor, RenderStats]:
    """Per-sample radiance (W*H*spp, 3) for all samples, and RenderStats."""
    return render_range(materials, scene, key, cfg, 0, cfg.n_samples, **kw)


def render_image(
    materials: torch.Tensor, scene: SceneData, key: int, cfg: RenderConfig, **kw
) -> torch.Tensor:
    """Tone-mapped (H, W, 3) float image in [0, 1)."""
    samples, _ = render_samples(materials, scene, key, cfg, **kw)
    return tonemap_mean(samples, cfg.spp).reshape(cfg.height, cfg.width, 3)


def render_to_png(
    materials: torch.Tensor, scene: SceneData, key: int, cfg: RenderConfig,
    path: str, **kw
) -> torch.Tensor:
    """Render, write an 8-bit RGB PNG, and return the (H, W, 3) uint8 image
    (on the CPU)."""
    img8 = tonemap_to_uint8(render_image(materials, scene, key, cfg, **kw)).cpu()
    write_png(path, img8.numpy())
    return img8

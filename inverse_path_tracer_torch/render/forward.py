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
launches of cfg.tile_size samples through
ops/kernels/render_kernel.render_tile (the CUDA kernel on the card) or
render_tile_plain (cfg.backend="plain").
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    pack_tables,
    render_tile,
    render_tile_plain,
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


def _tile_fn(cfg: RenderConfig, scene: SceneData, materials: torch.Tensor):
    """The per-launch function; on CUDA the kernel's tables are packed once
    per range, not once per launch."""
    if cfg.backend == "plain":
        return render_tile_plain
    if scene.device.type == "cuda":
        return functools.partial(render_tile, tables=pack_tables(scene, materials))
    return render_tile


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
    """Radiance (count, 3) for the global sample indices start..start+count.

    cfg.rng="fused": rays and uniforms come from the counter hash of `key`
    and the global sample index, so the result does not depend on
    cfg.tile_size or on how a render is split into ranges.
    cfg.rng="external": `rays` = (p, d), each (count, 3), and `uniforms`
    (max_bounces*8, count) are supplied by the caller; `key` is unused."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    materials = materials.to(device=dev, dtype=torch.float32)
    tile_fn = _tile_fn(cfg, scene, materials)
    external = cfg.rng == "external"
    if external:
        if rays is None or uniforms is None:
            raise ValueError("rng='external' needs rays=(p, d) and uniforms")
        p_all, d_all = (r.to(device=dev, dtype=torch.float32) for r in rays)
        u_all = uniforms.to(device=dev, dtype=torch.float32)
        if p_all.shape != (count, 3) or d_all.shape != (count, 3):
            raise ValueError(f"rays must be (count, 3) = ({count}, 3)")
        if u_all.shape != (cfg.max_bounces * 8, count):
            raise ValueError(f"uniforms must be ({cfg.max_bounces * 8}, {count})")
    elif rays is not None or uniforms is not None:
        raise ValueError("rays/uniforms are only read with rng='external'")
    keys = None if external else rng.key_words(key)

    out = torch.empty((count, 3), dtype=torch.float32, device=dev)
    totals = torch.zeros(2, dtype=torch.float64, device=dev)
    tile = max(1, min(cfg.tile_size, count))
    for lo in range(0, count, tile):
        hi = min(lo + tile, count)
        idx = torch.arange(start + lo, start + hi, dtype=torch.int64, device=dev)
        alive = (idx < cfg.n_samples).to(torch.float32)[None, :]
        if external:
            p, d = p_all[lo:hi], d_all[lo:hi]
            u = u_all[:, lo:hi].contiguous()
        else:
            p, d = camera_rays(scene, cfg, key, idx)
            u = None
        rad, stats = tile_fn(
            materials, scene, cfg, p.T.contiguous(), d.T.contiguous(), alive,
            uniforms=u, orig=idx.to(torch.int32)[None, :].contiguous(), keys=keys,
        )
        out[lo:hi] = rad.T
        totals += stats.sum(dim=1, dtype=torch.float64)
    counts = totals.to(torch.int64)
    return out, RenderStats(segments=counts[0], shadow_rays=counts[1])


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

"""Primary rays of the pinhole camera, and the launch description with which
the kernels make them themselves.

camera_rays is the plain PyTorch version of render_common.cuh camera_ray:
elementwise tensor operations in the kernel's order (no torch.linalg.norm,
no matmul), so that every product, sum, square root and divide rounds once,
as in the kernel under -fmad=false.  Divisors are tensors on the rays'
device: PyTorch's CUDA division by a CPU scalar multiplies by its
reciprocal, which would round differently from the kernel's divide.  The
square root is taken in float64 and rounded to float32, which gives the
correctly rounded float32 root (float64 has more than 2 * 24 + 2 bits) on
any device, as sqrtf does: PyTorch's float32 sqrt on the CPU is not
always correctly rounded.

A Camera stands for the primary rays of one launch: lane i traces global
sample base + i, alive where that index is below cfg.n_samples, its jitter
drawn under the seed `key`.  The kernels take it in place of the (3, n)
ray tensors (TraceParams.camera); their plain versions turn it back into
those tensors with camera_inputs, so the two routes take the same
arguments.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.vec import dot3


class Camera(NamedTuple):
    """The primary rays of one launch: global samples base .. base + n - 1,
    jittered under the seed `key` (the forward's key; the extraction's
    rng.fold_in(key, rng.CAMERA_STREAM))."""

    base: int
    n: int
    key: int


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """render_common.cuh normalize3 of rows v (n, 3): v / |v|, zero rows
    unchanged, |v| the correctly rounded float32 root (module docstring)."""
    n = torch.sqrt(dot3(v, v).double()).float()
    return v / torch.where(n > 0, n, torch.ones_like(n))[..., None]


def camera_rays_from_jitter(
    scene, cfg, sample_idx: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays (n, 3) for global sample indices (r*W + c)*spp + s with
    pixel jitter (u1, u2) (reference path_trace.cu:155-165): x = 2(c+u1)/W -
    1, y = 1 - 2(r+u2)/H, d = M33 normalize(x, y, 1), normalized, origin 0
    (the eye translation is dropped, scene/build.py).  The operations are
    render_common.cuh camera_ray's, in its order."""
    dev = sample_idx.device
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    r = (sample_idx // (cfg.spp * cfg.width)).to(torch.float32)
    c = ((sample_idx // cfg.spp) % cfg.width).to(torch.float32)
    x = 2.0 * (c + u1) / f32(cfg.width) - 1.0
    y = 1.0 - 2.0 * (r + u2) / f32(cfg.height)
    d = _normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))
    m = scene.cam_m33.to(device=dev, dtype=torch.float32)
    d = _normalize(d[:, 0:1] * m[:, 0] + d[:, 1:2] * m[:, 1] + d[:, 2:3] * m[:, 2])
    return torch.zeros_like(d), d


def camera_rays(scene, cfg, key: int, sample_idx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays with the jitter of the counter-hash RNG (bounce 0,
    slots 6 and 7 of each sample's stream under `key`)."""
    h = rng.hash_orig(rng.key_words(key), sample_idx)
    u = rng.draw(rng.key_words(key), h, 0, (rng.SLOT_JITTER_X, rng.SLOT_JITTER_Y))
    return camera_rays_from_jitter(scene, cfg, sample_idx, u[0], u[1])


def sample_index(camera: Camera, device) -> torch.Tensor:
    """The launch's global sample indices base .. base + n - 1, (n,) int64."""
    return torch.arange(camera.base, camera.base + camera.n, dtype=torch.int64, device=device)


def pixel_index(cfg, idx: torch.Tensor) -> torch.Tensor:
    """The image row clip(idx // spp, 0, W*H - 1) of each global sample
    index (int64, as the kernels' lane_pix divides g)."""
    return torch.clamp(idx.long() // cfg.spp, 0, cfg.width * cfg.height - 1)


def camera_inputs(scene, cfg, camera: Camera) -> Dict[str, torch.Tensor]:
    """The kernel inputs p, d (3, n), alive (1, n) and orig (1, n) int32 of
    the launch `camera` describes, on the scene's device: the rays the
    kernels make in camera mode."""
    idx = sample_index(camera, scene.device)
    p, d = camera_rays(scene, cfg, camera.key, idx)
    return dict(p=p.T.contiguous(), d=d.T.contiguous(),
                alive=(idx < cfg.n_samples).to(torch.float32)[None, :],
                orig=idx.to(torch.int32)[None, :].contiguous())

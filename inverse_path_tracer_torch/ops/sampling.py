"""Direction and light sampling (reference path_trace.cu:30-62, 91-109).

Returned pdfs are the reference's: 1/pi for a cosine-sampled diffuse
direction (quirk Q3) and ((n+1) cos)^n for the Phong lobe.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from inverse_path_tracer_torch.ops.vec import normalize3
from inverse_path_tracer_torch.scene.build import SceneData

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi


def rotate_z_to(norm_dir: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Rotate `vec` by the minimal rotation taking +z to `norm_dir`
    (Eigen Quaternionf::FromTwoVectors((0,0,1), n)), with the reference's
    R = -I when n.z == -1 (path_trace.cu:97-103)."""
    w = 1.0 + norm_dir[..., 2]
    x = -norm_dir[..., 1]
    y = norm_dir[..., 0]
    qn2 = w * w + x * x + y * y
    degenerate = qn2 <= 1e-12
    qn = torch.sqrt(torch.where(degenerate, torch.ones_like(qn2), qn2))
    w, x, y = w / qn, x / qn, y / qn
    vx, vy, vz = vec[..., 0], vec[..., 1], vec[..., 2]
    rx = (1 - 2 * y * y) * vx + (2 * x * y) * vy + (2 * y * w) * vz
    ry = (2 * x * y) * vx + (1 - 2 * x * x) * vy + (-2 * x * w) * vz
    rz = (-2 * y * w) * vx + (2 * x * w) * vy + (1 - 2 * (x * x + y * y)) * vz
    rotated = torch.stack([rx, ry, rz], dim=-1)
    return torch.where(degenerate[..., None], -vec, rotated)


def sample_next_dir(
    norm_dir: torch.Tensor,  # (R, 3) FACE normal
    is_specular: Optional[torch.Tensor],  # (R,) bool, or None: no Ks in the scene
    shininess: torch.Tensor,  # (R,)
    u_phi: torch.Tensor,  # (R,)
    u_theta: torch.Tensor,  # (R,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sample the next direction: phi = 2 pi u1, cos(theta) =
    u2^(1/2) (diffuse) or u2^(1/(n+1)) (specular).  Returns (next_dir
    (R,3), pdf (R,)).  is_specular=None is the scene-wide diffuse case,
    where u2^(1/2) is an exact sqrt."""
    phi = TWO_PI * u_phi
    if is_specular is None:
        cos_t = torch.sqrt(u_theta)
        pdf = torch.full_like(u_theta, INV_PI)
    else:
        exponent = torch.where(is_specular, 1.0 / (shininess + 1.0),
                               torch.full_like(shininess, 0.5))
        cos_t = torch.pow(u_theta, exponent)
        pdf = torch.where(is_specular, torch.pow((shininess + 1.0) * cos_t, shininess),
                          torch.full_like(cos_t, INV_PI))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    hemi = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    return normalize3(rotate_z_to(norm_dir, hemi)), pdf


def pick_emissive(scene: SceneData, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Area-CDF pick (path_trace.cu:40-51): the first emitter whose inclusive
    CDF is >= u, the last one when u exceeds cdf[-1].  Returns (global
    triangle index (R,), selection prob (R,))."""
    e = torch.searchsorted(scene.emissive_cdf, u.contiguous(), side="left")
    e = torch.clamp(e, max=scene.n_emissive - 1)
    return scene.emissive_idx[e], scene.emissive_p[e]


def sample_emissive_point(
    scene: SceneData, tri: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor
) -> torch.Tensor:
    """sqrt-barycentric point (path_trace.cu:55-62):
    (1 - sqrt(r1)) v1 + sqrt(r1)(1 - r2) v2 + r2 sqrt(r1) v3."""
    v = scene.vertices[tri]  # (R, 3, 3)
    sq = torch.sqrt(r1)[:, None]
    r2 = r2[:, None]
    return (1.0 - sq) * v[:, 0] + sq * (1.0 - r2) * v[:, 1] + r2 * sq * v[:, 2]

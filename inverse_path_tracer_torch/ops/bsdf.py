"""BSDF evaluation (reference path_trace.cu:10-28).

The reference's BSDF is a diagonal 3x3 matrix, carried here as a vec3.  The
forward renderer divides diffuse by pi only for *indirect* bounces (part of
the behavioural contract).
"""

from __future__ import annotations

import math

import torch

from inverse_path_tracer_torch.ops.vec import dot3
from inverse_path_tracer_torch.scene.build import SceneData

PI = math.pi
INV_PI = 1.0 / PI
INV_2PI = 0.5 / PI


def specular_coeff(
    shininess: torch.Tensor,  # (R,)
    shade_normal: torch.Tensor,  # (R, 3)
    w: torch.Tensor,  # (R, 3) outgoing query dir (the ray's d)
    w_i: torch.Tensor,  # (R, 3) incoming light dir
) -> torch.Tensor:
    """Phong lobe (n+2)/(2 pi) * max(refl.w, 0)^n.  pow(x, 0) = 1 as in C;
    a negative base gives 0 (CUDA's fmaxf(NaN, 0))."""
    refl = -w_i + (2.0 * dot3(shade_normal, w_i))[:, None] * shade_normal
    base = dot3(refl, w)
    one = torch.ones_like(base)
    powed = torch.where(
        shininess == 0.0,
        one,
        torch.where(base > 0.0, torch.pow(torch.clamp(base, min=0.0), shininess),
                    torch.zeros_like(base)),
    )
    return (shininess + 2.0) * INV_2PI * powed


def bsdf_from_values(
    kd: torch.Tensor,  # (R, 3)
    spec: torch.Tensor,  # (R, 3)
    shininess: torch.Tensor,  # (R,)
    shade_normal: torch.Tensor,  # (R, 3)
    w: torch.Tensor,
    w_i: torch.Tensor,
    is_direct: bool,
) -> torch.Tensor:
    """Diffuse (/pi iff indirect) + Phong specular, per-lane values given."""
    diffuse = kd if is_direct else kd * INV_PI
    coeff = specular_coeff(shininess, shade_normal, w, w_i)
    return diffuse + spec * coeff[:, None]


def bsdf_diagonal(
    materials: torch.Tensor,  # (nT, 3)
    scene: SceneData,
    tri: torch.Tensor,  # (R,) int
    shade_normal: torch.Tensor,
    w: torch.Tensor,
    w_i: torch.Tensor,
    is_direct: bool,
) -> torch.Tensor:
    return bsdf_from_values(
        materials[tri], scene.specular[tri], scene.shininess[tri],
        shade_normal, w, w_i, is_direct,
    )

"""Ray-triangle closest hit by brute force over all triangles.

Contract (reference scene_basics.h:426-459):
  * plane test: reject |n.d| < MIN_DOT;
  * t = (p - center).n / -(n.d); reject t < EPSILON;
  * inside test: signed distance to the 3 edge planes, reject if any > 0;
  * nearest t wins; exact ties keep the lowest triangle index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from inverse_path_tracer_torch.ops.vec import cross3, dot3, normalize3
from inverse_path_tracer_torch.scene.build import SceneData


class Intersection(NamedTuple):
    t: torch.Tensor  # (R,) hit distance (inf on miss)
    tri: torch.Tensor  # (R,) int64 triangle index (0 on miss; use .hit)
    point: torch.Tensor  # (R, 3) p + t*d (p on miss)
    hit: torch.Tensor  # (R,) bool


def plane_rows(scene: SceneData) -> torch.Tensor:
    """(nT, 16) per-triangle planes [n, -c.n, out0, d0, out1, d1, out2, d2]
    from the packed (4, 4*nT) plane_mat."""
    n_t = scene.n_tri
    return scene.plane_mat.reshape(4, n_t, 4).permute(1, 2, 0).reshape(n_t, 16).contiguous()


def _closest(t_masked: torch.Tensor, p: torch.Tensor, d: torch.Tensor) -> Intersection:
    idx = torch.argmin(t_masked, dim=1)  # first minimum: lowest index on ties
    t_best = torch.gather(t_masked, 1, idx[:, None])[:, 0]
    hit = torch.isfinite(t_best)
    t_safe = torch.where(hit, t_best, torch.zeros_like(t_best))
    return Intersection(
        t=t_best,
        tri=torch.where(hit, idx, torch.zeros_like(idx)),
        point=p + d * t_safe[:, None],
        hit=hit,
    )


def _project(plane: torch.Tensor, v: torch.Tensor, w: bool) -> torch.Tensor:
    """(R, T) values v.plane[:3] (+ plane[3] for points), summed in order."""
    out = (
        v[:, 0:1] * plane[None, :, 0]
        + v[:, 1:2] * plane[None, :, 1]
        + v[:, 2:3] * plane[None, :, 2]
    )
    return out + plane[None, :, 3] if w else out


def intersect_planes(
    planes: torch.Tensor,  # (nT, 16), see plane_rows
    p: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    min_dot: float = 1e-4,
    epsilon: float = 1e-2,
) -> Intersection:
    """Closest hit against packed plane rows, in the CUDA kernel's order:
    t = a0 / -b0 with a = p.plane + w, b = d.plane; sd_j = a_j + t b_j."""
    a0 = _project(planes[:, 0:4], p, True)
    b0 = _project(planes[:, 0:4], d, False)
    t = a0 / (-b0)
    inside = (torch.abs(b0) >= min_dot) & (t >= epsilon)
    for j in (1, 2, 3):
        pl = planes[:, 4 * j : 4 * j + 4]
        inside = inside & (_project(pl, p, True) + t * _project(pl, d, False) <= 0.0)
    inf = torch.full_like(t, float("inf"))
    return _closest(torch.where(inside, t, inf), p, d)


def intersect_fast(
    scene: SceneData, p: torch.Tensor, d: torch.Tensor,
    min_dot: float = 1e-4, epsilon: float = 1e-2,
) -> Intersection:
    """intersect_planes on the scene's packed planes."""
    return intersect_planes(plane_rows(scene), p, d, min_dot, epsilon)


def intersect_brute(
    scene: SceneData, p: torch.Tensor, d: torch.Tensor,
    min_dot: float = 1e-4, epsilon: float = 1e-2,
) -> Intersection:
    """The same contract from the unpacked fields (face normal, centre,
    edge planes)."""
    n = scene.face_normal
    denom = d @ n.T  # (R, T)
    t = (p @ n.T - torch.sum(scene.center * n, dim=-1)[None, :]) / (-denom)
    inside = (torch.abs(denom) >= min_dot) & (t >= epsilon)
    for j in range(3):
        oj = scene.edge_out[:, j, :]
        sd = (p @ oj.T) + t * (d @ oj.T) + scene.edge_d[None, :, j]
        inside = inside & (sd <= 0.0)
    inf = torch.full_like(t, float("inf"))
    return _closest(torch.where(inside, t, inf), p, d)


def smooth_normal_from(
    v: torch.Tensor,  # (R, 3, 3) triangle corners
    ns: torch.Tensor,  # (R, 3, 3) corner normals
    area: torch.Tensor,  # (R,)
    point: torch.Tensor,  # (R, 3)
) -> torch.Tensor:
    """Barycentric shading normal (reference Triangle::getNormal
    scene_basics.h:100-109): w_i = 0.5 |(v_{i+1} - p) x (v_{i+2} - p)| /
    area, normal = normalize(sum_i w_i n_i).  Zero-area rows give 0."""
    a_safe = torch.where(area > 0, area, torch.ones_like(area))
    acc = torch.zeros_like(point)
    for i in range(3):
        c = cross3(v[:, (i + 1) % 3] - point, v[:, (i + 2) % 3] - point)
        w = 0.5 * torch.sqrt(dot3(c, c)) / a_safe
        acc = acc + w[:, None] * ns[:, i]
    return normalize3(acc)


def smooth_normal(scene: SceneData, tri: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Shading normal at `point` on triangles `tri`: the face normal on flat
    scenes, the barycentric interpolation otherwise."""
    if not scene.has_vertex_normals:
        return scene.face_normal[tri]
    return smooth_normal_from(
        scene.vertices[tri], scene.vertex_normals[tri], scene.area[tri], point
    )

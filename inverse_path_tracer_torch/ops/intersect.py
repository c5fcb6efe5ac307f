"""Ray-triangle closest hit by brute force over all triangles, and the
clustered sweep (the plain version of kernel B10).

Contract (reference scene_basics.h:426-459):
  * plane test: reject |n.d| < MIN_DOT;
  * t = (p - center).n / -(n.d); reject t < EPSILON;
  * inside test: signed distance to the 3 edge planes, reject if any > 0;
  * nearest t wins; exact ties keep the lowest triangle index.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch

# Rays per chunk of a sweep are chosen so that one (rays, triangles) float
# tensor stays near this many elements.
_CHUNK_ELEMENTS = 1 << 24
# Set by counting_sweeps(): running totals of the clustered sweeps.
_counts: Optional[Dict[str, int]] = None

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


def _t_masked(planes: torch.Tensor, p: torch.Tensor, d: torch.Tensor, min_dot: float,
              epsilon: float) -> torch.Tensor:
    """(R, T) hit distances, +inf where a test rejects, in the CUDA
    kernel's order: t = a0 / -b0 with a = p.plane + w, b = d.plane; sd_j =
    a_j + t b_j."""
    a0 = _project(planes[:, 0:4], p, True)
    b0 = _project(planes[:, 0:4], d, False)
    t = a0 / (-b0)
    inside = (torch.abs(b0) >= min_dot) & (t >= epsilon)
    for j in (1, 2, 3):
        pl = planes[:, 4 * j : 4 * j + 4]
        inside = inside & (_project(pl, p, True) + t * _project(pl, d, False) <= 0.0)
    return torch.where(inside, t, torch.full_like(t, float("inf")))


def _chunks(n_rays: int, n_tri: int):
    step = max(1, _CHUNK_ELEMENTS // max(n_tri, 1))
    return [slice(lo, min(lo + step, n_rays)) for lo in range(0, n_rays, step)] or [slice(0, 0)]


def _min_over(planes, p, d, min_dot, epsilon):
    """(t_best, idx) of the closest hit of each ray over `planes`, rays in
    chunks so that memory stays bounded; idx is the first minimum."""
    ts, idxs = [], []
    for s in _chunks(p.shape[0], planes.shape[0]):
        t_min, idx = torch.min(_t_masked(planes, p[s], d[s], min_dot, epsilon), dim=1)
        ts.append(t_min)
        idxs.append(idx)
    return torch.cat(ts), torch.cat(idxs)


def _resolve(t_best: torch.Tensor, idx: torch.Tensor, p: torch.Tensor, d: torch.Tensor
             ) -> Intersection:
    hit = torch.isfinite(t_best)
    t_safe = torch.where(hit, t_best, torch.zeros_like(t_best))
    return Intersection(t=t_best, tri=torch.where(hit, idx, torch.zeros_like(idx)),
                        point=p + d * t_safe[:, None], hit=hit)


def intersect_planes(
    planes: torch.Tensor,  # (nT, 16), see plane_rows
    p: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    min_dot: float = 1e-4,
    epsilon: float = 1e-2,
) -> Intersection:
    """Closest hit against packed plane rows (see _t_masked)."""
    t_best, idx = _min_over(planes, p, d, min_dot, epsilon)
    return _resolve(t_best, idx, p, d)


def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Reciprocal direction for slab tests: components below 1e-20 in
    magnitude become +-1e-20 (the sign of d, + for +-0)."""
    tiny = torch.where(d < 0, torch.full_like(d, -1e-20), torch.full_like(d, 1e-20))
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


def enters_box(box: torch.Tensor, p: torch.Tensor, inv_d: torch.Tensor, t_best: torch.Tensor
               ) -> torch.Tensor:
    """(R,) bool: the ray's [0, inf) enters the box (row [lo xyz, hi xyz,
    ...]) no later than t_best."""
    t1 = (box[0:3] - p) * inv_d
    t2 = (box[3:6] - p) * inv_d
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    t_min = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    t_max = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return (t_max >= torch.clamp(t_min, min=0.0)) & (t_min <= t_best)


def intersect_clustered(
    planes: torch.Tensor,  # (nT, 16) in internal order
    cab: torch.Tensor,  # (C, 8) cluster boxes (ops/kernels/clusters.py)
    gab: torch.Tensor,  # (G, 8) boxes of the groups of `group` clusters 1..
    cluster_k: int,
    group: int,
    p: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    min_dot: float = 1e-4,
    epsilon: float = 1e-2,
) -> Intersection:
    """The clustered sweep of B10 as a per-lane loop: cluster 0 swept for
    every ray; then, group by group, the clusters of a group's box that the
    ray enters no later than its closest hit so far, each swept where the
    ray enters its own box no later than its closest hit so far; a
    cluster's hit replaces the running one only when strictly closer, so
    ties keep the lowest index.  Equal to intersect_planes on the same
    planes, bit for bit, because every triangle of a cluster lies inside its
    padded box and every cluster box inside its group's box.  Its tests and pairs are the
    least that a sweep in this order needs; render_common.cuh cluster_hit
    shares them over a warp's lanes and may cull later, so it tests and
    sweeps as many or more (intersect_tile's `counts`)."""
    n_tri, n_rays = planes.shape[0], p.shape[0]
    t_best = torch.full((n_rays,), float("inf"), dtype=torch.float32, device=p.device)
    best = torch.zeros(n_rays, dtype=torch.int64, device=p.device)
    inv_d = inv_dir(d)
    counting = _counts is not None
    if counting:  # the clusters that each warp's rays (32 in a row) sweep
        swept = torch.zeros((-(-n_rays // 32), cab.shape[0]), dtype=torch.bool, device=p.device)

    def sweep_cluster(c, rows):
        lo, hi = c * cluster_k, min((c + 1) * cluster_k, n_tri)
        if counting:
            _counts["pairs"] += rows.numel() * (hi - lo)
            swept[rows // 32, c] = True
        if rows.numel() == 0:
            return
        t_c, i_c = _min_over(planes[lo:hi], p[rows], d[rows], min_dot, epsilon)
        better = t_c < t_best[rows]
        t_best[rows] = torch.where(better, t_c, t_best[rows])
        best[rows] = torch.where(better, i_c + lo, best[rows])

    def entering(box, rows):
        got = rows[enters_box(box, p[rows], inv_d[rows], t_best[rows])]
        return got, rows.numel(), got.numel()

    every = torch.arange(n_rays, device=p.device)
    sweep_cluster(0, every)
    for g in range(gab.shape[0]):
        rows_g, tested, entered = entering(gab[g], every)
        if counting:
            _counts["group_tests"] += tested
            _counts["group_entered"] += entered
        for c in range(1 + g * group, min(1 + (g + 1) * group, cab.shape[0])):
            rows, tested, entered = entering(cab[c], rows_g)
            if counting:
                _counts["tests"] += tested
                _counts["entered"] += entered
            sweep_cluster(c, rows)
    if counting:
        rows_of = (n_tri - torch.arange(cab.shape[0], device=p.device) * cluster_k).clamp(
            max=cluster_k)
        _counts["loop_slots"] += 32 * int((swept.long() * rows_of).sum())
    return _resolve(t_best, best, p, d)


@contextlib.contextmanager
def counting_sweeps():
    """Counts, inside the block, the clustered sweeps' (ray, group) box
    tests and how many of them entered, the (ray, cluster) box tests of
    clusters 1.. inside entered groups and how many of them entered, the
    (ray, triangle) pairs swept, and the lane-slots that the per-lane loop
    issues on a card (`loop_slots`, B10's schedule before its
    warp-cooperative sweep: 32 for each row of each cluster that any ray of
    a warp, 32 rays of a call in a row, sweeps); and ops/bvh.py
    intersect_bvh's nodes visited, (ray, node box) tests, (ray, triangle)
    tests and visits culled by the entry distance: yields the dict of
    running totals."""
    global _counts
    _counts = {"group_tests": 0, "group_entered": 0, "tests": 0, "entered": 0, "pairs": 0,
               "loop_slots": 0, "nodes": 0, "node_tests": 0, "tri_tests": 0, "culled": 0}
    try:
        yield _counts
    finally:
        _counts = None


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

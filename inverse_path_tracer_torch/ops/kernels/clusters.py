"""Cluster metadata of the clustered sweep (B10) and the kernels' view of a
scene (the counterpart of the JAX package's cluster_k_for, _morton_codes,
_morton_order, kernel_perm, the cluster part of _pack_tables and
unperm_rows, ops/pallas/render_kernel.py:134-244, :1381-1411).

On a scene of at least CLUSTER_MIN_TP padded triangles the kernels keep
their triangles in an internal order: the cluster_k largest triangles (by
the squared diagonal of their box) first, the rest by the Morton code of
their centroid.  Contiguous runs of cluster_k internal triangles form the
clusters; cluster 0 (the hot one) is always swept, every other cluster
only by a ray that enters its margin-padded box.  Ties keep the lowest
internal index.  Everything that carries a triangle index out of a kernel
(records, dMaterials rows, the edge grid) is internal and is mapped back to
global order with `perm` (perm[i] = the global index of internal row i).

kernel_view() gives the plain versions the same order: a SceneData whose
per-triangle fields are permuted and whose emitter indices are internal.

On the BVH route (uses_bvh: cfg.intersect == "bvh" on a scene with a BVH)
the internal order is instead the tree's leaf order, perm = the BVH's
tri_order, so that a leaf's triangles are contiguous rows; the view keeps
the BVH and the scene in global order, which its traversal indexes.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, NamedTuple, Optional

import torch

from inverse_path_tracer_torch.scene.build import SceneData
from inverse_path_tracer_torch.utils.profiling import span

if TYPE_CHECKING:
    from inverse_path_tracer_torch.ops.bvh import BVHData

# The clustered sweep is used at padded triangle counts of at least
# CLUSTER_MIN_TP (cluster_k_for); CLUSTER_K, when not 0, overrides the auto
# width for every config that does not set cfg.cluster_k.  Tests that need
# clusters on a small scene set these module constants.
CLUSTER_MIN_TP = 128
CLUSTER_K = 0
# The auto width on the H100 (cluster_k_for) and the clusters per group box
# (clusters.group_boxes, the first level of the kernels' two-level box test).
CLUSTER_AUTO_K = 16
CLUSTER_GROUP = 8

# Fields of SceneData indexed by triangle.
_TRI_FIELDS = ("vertices", "vertex_normals", "face_normal", "center", "area", "edge_out",
               "edge_d", "diffuse", "specular", "emission", "shininess")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cluster_k_for(n_tri: int, cfg) -> int:
    """The cluster width of the sweep (0 = dense): CLUSTER_AUTO_K on scenes
    of at least CLUSTER_MIN_TP padded triangles; cfg.cluster_k, then
    CLUSTER_K, override it, rounded up to a multiple of 8.

    The threshold is the H100's too: on the 242-triangle vertex-normal scene
    (248 padded; the box and an 8-ring, 16-segment sphere), at the first
    2^20-ray launch of its 500x500/100 spp/16 bounce extraction, B6 with
    the global-grid sink took 3.57-3.58 ms with clusters of 16 against
    7.41-7.47 ms dense, and B1 on its first 512x512/64 spp launch 6.41-6.42
    ms against 17.82-17.91 ms (tools/time_extract.py, one call, H100 80GB
    HBM3 at 700 W); the JAX package's threshold is 512.  The threshold also
    makes wavefront="auto" stage that scene: its render_image at 512x512/64
    spp/16 bounces took 123.9-126.2 ms staged with clusters of 16 (131.3-
    142.3 mega, clustered) against 317.5-320.4 ms dense mega, its
    loss_and_grad_range 138.1-155.9 ms against 333.4-337.0 ms
    (tools/time_extract.py, the tree at 512 and at 128 as A B B A in one
    call, same card).

    The auto width is the H100's: each thread skips clusters for its own
    ray, so narrow clusters pay.  On an H100 80GB HBM3 (700 W) the
    1298-triangle large scene's staged forward (512x512/64 spp/16 bounces,
    tools/time_render_fwd.py, two runs each in one call) took 186-191 ms at
    width 16, 207-210 ms at 32, 276 ms at 64, 357-360 ms at 128 and 692-695
    ms at 768.  The JAX package's auto width, tuned for a TPU that skips a
    cluster for a whole block of rays and so prefers wide clusters, is half
    the padded count clamped to [256, 1024]: 768 on the large scene, which
    puts 59% of its triangles in the always-swept hot cluster.
    cfg.cluster_k=768 gives that layout, and JAX's kernel_perm, bit for
    bit."""
    tp8 = _round_up(max(n_tri, 8), 8)
    if tp8 < CLUSTER_MIN_TP:
        return 0
    for k in (cfg.cluster_k, CLUSTER_K):
        if k:
            if k < 0:
                raise ValueError(f"cluster_k must be positive, got {k}")
            return _round_up(k, 8)
    return CLUSTER_AUTO_K


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every third position."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_codes(cent: torch.Tensor, lo: torch.Tensor, inv_ext: torch.Tensor) -> torch.Tensor:
    """(nT,) int64 Morton codes of centroids: 10 quantised bits per axis,
    interleaved x|y|z."""
    q = torch.clamp(((cent - lo) * inv_ext * 1024.0).to(torch.int32), 0, 1023).to(torch.int64)
    return _expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1) | (_expand_bits(q[:, 2]) << 2)


def morton_order(vertices: torch.Tensor, hot: int = 0) -> torch.Tensor:
    """(nT,) int64 internal -> global order: the `hot` largest triangles
    first (descending size), the rest by centroid Morton code, stable.
    Computed on the CPU in float32 with the JAX package's operation order,
    so that both packages give the same order."""
    v = vertices.detach().to("cpu", torch.float32)
    cent = (v[:, 0] + v[:, 1] + v[:, 2]) / 3.0
    lo = cent.min(dim=0).values
    ext = cent.max(dim=0).values - lo
    inv_ext = 1.0 / torch.where(ext > 0, ext, torch.ones_like(ext))
    codes = torch.clamp(morton_codes(cent, lo, inv_ext), 0, (1 << 30) - 1)
    if hot <= 0:
        return torch.argsort(codes, stable=True)
    dv = v.max(dim=1).values - v.min(dim=1).values
    size = dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1] + dv[:, 2] * dv[:, 2]
    rank = torch.argsort(torch.argsort(-size, stable=True), stable=True)
    key = torch.where(rank < hot, rank, (1 << 30) + codes)
    return torch.argsort(key, stable=True)


def uses_bvh(scene: SceneData, cfg) -> bool:
    """Whether the render takes the BVH route: cfg.intersect == "bvh" on a
    scene that carries a BVH (the JAX package's _intersect rule)."""
    return cfg is not None and cfg.intersect == "bvh" and scene.bvh is not None


def kernel_perm(scene: SceneData, cfg) -> Optional[torch.Tensor]:
    """The internal -> global triangle order of the kernels (on the
    scene's device): the BVH's leaf order on the BVH route, else the
    clustered order, or None where the scene keeps global order (dense
    sweep, or cfg.tri_order == "file").  The Morton order, sorted on the
    host, runs under the span ipt.prep.perm."""
    if uses_bvh(scene, cfg):
        return scene.bvh.tri_order.to(scene.device, torch.int64)
    ck = cluster_k_for(scene.n_tri, cfg)
    if ck == 0 or cfg.tri_order != "morton":
        return None
    with span("ipt.prep.perm"):
        return morton_order(scene.vertices, hot=ck).to(scene.device)


def unperm_rows(d: torch.Tensor, perm: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows of internal order -> global order (row perm[i] <- row i)."""
    if perm is None:
        return d
    out = torch.zeros_like(d)
    out[perm] = d
    return out


def cluster_boxes(vertices: torch.Tensor, cluster_k: int) -> torch.Tensor:
    """(C, 8) boxes of the clusters of internally ordered triangles: rows
    [lo xyz, hi xyz, 0, 0], padded by 1e-4 of their extent plus 1e-5, so
    that rounding in the slab test never culls a grazing hit."""
    n_tri = vertices.shape[0]
    c = -(-n_tri // cluster_k)
    pad = c * cluster_k - n_tri
    inf = torch.full((pad, 3), float("inf"), dtype=torch.float32, device=vertices.device)
    lo_t = torch.cat([vertices.min(dim=1).values, inf])
    hi_t = torch.cat([vertices.max(dim=1).values, -inf])
    lo_c = lo_t.reshape(c, cluster_k, 3).min(dim=1).values
    hi_c = hi_t.reshape(c, cluster_k, 3).max(dim=1).values
    m = 1e-4 * (hi_c - lo_c) + 1e-5
    return torch.cat([lo_c - m, hi_c + m, torch.zeros_like(lo_c[:, :2])], dim=1).contiguous()


def group_boxes(cab: torch.Tensor, group: int) -> torch.Tensor:
    """(ceil((C - 1) / group), 8) boxes of the groups of `group` consecutive
    clusters 1.. (cluster 0 is swept for every ray): rows [lo xyz, hi xyz,
    0, 0], the exact union of the group's cluster boxes, so that a ray that
    enters a cluster's box no later than t also enters its group's box no
    later than t (the slab test is monotone in the box's bounds)."""
    rest = cab[1:, :6]
    n_groups = -(-rest.shape[0] // group)
    pad = n_groups * group - rest.shape[0]
    inf = torch.full((pad, 3), float("inf"), dtype=cab.dtype, device=cab.device)
    lo = torch.cat([rest[:, 0:3], inf]).reshape(n_groups, group, 3).min(dim=1).values
    hi = torch.cat([rest[:, 3:6], -inf]).reshape(n_groups, group, 3).max(dim=1).values
    return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], dim=1).contiguous()


class KernelView(NamedTuple):
    """A scene as the kernels see it."""

    scene: SceneData  # per-triangle fields in internal order, emitters internal
    perm: Optional[torch.Tensor]  # internal -> global, None = global order
    cluster_k: int  # 0 = dense sweep
    cab: Optional[torch.Tensor]  # (C, 8) cluster boxes
    gab: Optional[torch.Tensor] = None  # (G, 8) boxes of the groups of clusters 1..
    group: int = 0  # clusters per group box
    bvh: Optional["BVHData"] = None  # the BVH route's tree (global tri_order)
    source: Optional[SceneData] = None  # the BVH route's scene in global order


def permute_scene(scene: SceneData, perm: torch.Tensor) -> SceneData:
    """`scene` with its triangles in the order `perm` (internal -> global);
    emitter and specular indices become internal, emitters keep their
    order (the light-pick CDF is unchanged).  The BVH, which indexes the
    global order, is dropped."""
    inv = torch.argsort(perm)
    fields = {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}
    fields["bvh"] = None
    for name in _TRI_FIELDS:
        fields[name] = fields[name][perm]
    fields["emissive_idx"] = inv[scene.emissive_idx]
    fields["specular_idx"] = torch.sort(inv[scene.specular_idx]).values
    n_t = scene.n_tri
    fields["plane_mat"] = scene.plane_mat.reshape(4, n_t, 4)[:, perm].reshape(4, 4 * n_t)
    return SceneData(**fields)


def kernel_view(scene: SceneData, cfg) -> KernelView:
    """The kernels' view of `scene` under cfg (cfg None: dense, global).
    On the BVH route the tree must order the scene's triangles (its
    structure was checked where it entered the port: ops/bvh.py
    check_bvh)."""
    if uses_bvh(scene, cfg):
        if scene.bvh.tri_order.shape[0] != scene.n_tri:
            raise ValueError(f"the BVH orders {scene.bvh.tri_order.shape[0]} triangles, the "
                             f"scene has {scene.n_tri}")
        perm = kernel_perm(scene, cfg)
        return KernelView(permute_scene(scene, perm), perm, 0, None, bvh=scene.bvh, source=scene)
    ck = 0 if cfg is None else cluster_k_for(scene.n_tri, cfg)
    if ck == 0:
        return KernelView(scene, None, 0, None)
    perm = kernel_perm(scene, cfg)
    view = scene if perm is None else permute_scene(scene, perm)
    cab = cluster_boxes(view.vertices, ck)
    return KernelView(view, perm, ck, cab, group_boxes(cab, CLUSTER_GROUP), CLUSTER_GROUP)


def to_kernel_order(materials: torch.Tensor, view: KernelView) -> torch.Tensor:
    """Materials (nT, 3) in the view's internal order."""
    return materials if view.perm is None else materials[view.perm]

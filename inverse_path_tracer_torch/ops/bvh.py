"""BVH over triangles: a host-side builder and a traversal in plain PyTorch
(the counterpart of the JAX package's ops/bvh.py).

The builder is a midpoint split over triangle centroids, the reference's
split rule (bvh.h:175-190) over triangles instead of objects, into a
depth-first SoA: node i's left child is i + 1, its right child i +
right_offset[i]; a leaf holds n_prims > 0 triangles at slots start ..
start + n_prims - 1 of tri_order.  The Python builder gives the JAX
package's arrays exactly (the same split rule, degenerate-split halving and
stable sorts); native/src/ipt_native.cpp, through utils/native.py, builds
the same arrays when asked (use_native=True).

intersect_bvh traverses with a per-ray stack of MAX_STACK node indices, all
rays at once: a loop pops one node per ray and round until every stack is
empty, with masked updates (the leaf's triangles, the slab test, the near
child pushed last so that it pops first).  Rays whose stack emptied leave
the working set.  Two choices keep its hits those of the dense sweep
(ops/intersect.py intersect_planes), bit for bit:

  * the triangle test is the dense sweep's arithmetic on the same packed
    plane rows, in the same order;
  * the slab test pads each node's box as the clustered sweep pads its
    cluster boxes (1e-4 of the extent plus 1e-5), and culls a node only
    when the ray enters it strictly after the closest hit so far, so that
    rounding never culls a hit and exact ties reach the comparison, which
    keeps the lowest triangle index.

The renders traverse the BVH where RenderConfig.intersect is "bvh" and the
scene carries one (the BVH route): the plain versions through
intersect_bvh, the kernels through render_common.cuh traverse, which
visits the same nodes in the same order on the table of node_rows: one
64-byte row per inner node holding both children's padded boxes and a
reference to each, so that a visit is one row's load and each box is
tested once, by the parent, whose entry distance the stack keeps for the
pop's cull.  check_bvh validates a tree where it enters the port
(build_bvh, convert.py scene_from_numpy), so a render copies nothing to
the host; the kernel traps on a stack overflow as the last guard.
Elsewhere they sweep every triangle, clustered on large scenes
(ops/kernels/clusters.py), with the same hits.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from inverse_path_tracer_torch.ops import intersect as _intersect
from inverse_path_tracer_torch.ops.intersect import Intersection, plane_rows
from inverse_path_tracer_torch.scene.build import SceneData

MAX_STACK = 64  # the reference's traversal_t todo[64] (bvh.h:43)
LEAF_BITS = 5  # a leaf reference's triangle-count bits (node_rows; render_common.cuh kLeafBits)
_NO_TRI = 1 << 30


class BVHData(NamedTuple):
    bbox_min: torch.Tensor  # (M, 3) float32
    bbox_max: torch.Tensor  # (M, 3) float32
    start: torch.Tensor  # (M,) int32: first triangle slot (leaves)
    n_prims: torch.Tensor  # (M,) int32: 0 for inner nodes
    right_offset: torch.Tensor  # (M,) int32: right child = i + offset
    tri_order: torch.Tensor  # (nT,) int32: slot -> global triangle index

    @property
    def n_nodes(self) -> int:
        return self.start.shape[0]

    def to(self, device) -> "BVHData":
        return BVHData(*(t.to(device) for t in self))

    @classmethod
    def from_numpy(cls, arrays) -> "BVHData":
        """From the six arrays in field order (the JAX package's scene.bvh
        tuple) or a dict of them (utils/native.py build_bvh_native)."""
        if isinstance(arrays, dict):
            arrays = [arrays[f] for f in cls._fields]
        if len(arrays) != len(cls._fields):
            raise ValueError(f"a BVH has {len(cls._fields)} arrays, got {len(arrays)}")
        dtypes = (np.float32, np.float32, np.int32, np.int32, np.int32, np.int32)
        return cls(*(torch.from_numpy(np.array(a, dtype=t)) for a, t in zip(arrays, dtypes)))


def _build_python(verts: np.ndarray, leaf_size: int) -> dict:
    """The JAX package's numpy builder (its ops/bvh.py:77-134)."""
    n_t = verts.shape[0]
    cents = verts.mean(axis=1)
    tri_min = verts.min(axis=1)
    tri_max = verts.max(axis=1)
    order = np.arange(n_t)
    nodes = []  # [bmin, bmax, start, n_prims, right_offset]

    def recurse(lo: int, hi: int) -> int:
        idx = len(nodes)
        sel = order[lo:hi]
        node = [tri_min[sel].min(axis=0), tri_max[sel].max(axis=0), lo, hi - lo, 0]
        nodes.append(node)
        if hi - lo <= leaf_size:
            return idx
        c = cents[sel]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = 0.5 * (c[:, axis].max() + c[:, axis].min())
        left_mask = c[:, axis] < mid
        n_left = int(left_mask.sum())
        if n_left == 0 or n_left == hi - lo:
            n_left = (hi - lo) // 2  # degenerate split: halve
            part = np.argsort(c[:, axis], kind="stable")
        else:
            part = np.argsort(~left_mask, kind="stable")
        order[lo:hi] = sel[part]
        node[3] = 0  # inner
        recurse(lo, lo + n_left)
        node[4] = recurse(lo + n_left, hi) - idx
        return idx

    if n_t:
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4 * n_t + 64))
        try:
            recurse(0, n_t)
        finally:
            sys.setrecursionlimit(old)
    col = lambda k, t: np.array([n[k] for n in nodes], dtype=t)
    return {"bbox_min": np.stack([n[0] for n in nodes]).astype(np.float32),
            "bbox_max": np.stack([n[1] for n in nodes]).astype(np.float32),
            "start": col(2, np.int32), "n_prims": col(3, np.int32),
            "right_offset": col(4, np.int32), "tri_order": order.astype(np.int32)}


def build_bvh(scene: SceneData, leaf_size: int = 4, use_native: bool = False) -> BVHData:
    """The BVH of the scene's triangles, on the scene's device, checked by
    check_bvh.  use_native=True asks for the C++ builder (utils/native.py),
    which is taken when it is available; both give the same arrays."""
    verts = scene.vertices.detach().to("cpu", torch.float32).numpy()
    arrays = None
    if use_native:
        from inverse_path_tracer_torch.utils import native

        arrays = native.build_bvh_native(verts, leaf_size)
    if arrays is None:
        arrays = _build_python(verts, leaf_size)
    bvh = BVHData.from_numpy(arrays)
    check_bvh(bvh, scene.n_tri)
    return bvh.to(scene.device)


def attach_bvh(scene: SceneData, leaf_size: int = 4) -> SceneData:
    """The scene with a built BVH in its `bvh` field."""
    return scene.replace(bvh=build_bvh(scene, leaf_size=leaf_size))


def _padded_boxes(bvh: BVHData):
    """(lo, hi) of every node, padded as ops/kernels/clusters.py pads its
    cluster boxes."""
    m = 1e-4 * (bvh.bbox_max - bvh.bbox_min) + 1e-5
    return bvh.bbox_min - m, bvh.bbox_max + m


def check_bvh(bvh: BVHData, n_tri: int) -> None:
    """Raises ValueError unless `bvh` is a tree over n_tri triangles that
    the kernels' traversal takes: tri_order a permutation of the
    triangles, every leaf's slots inside it and within the node table's
    leaf reference (node_rows: at most 2**LEAF_BITS - 1 triangles, the
    first slot below 2**(31 - LEAF_BITS)), every inner node's children
    after it and inside the node table (left = i + 1, right = i +
    right_offset > i + 1), every node but the root the child of exactly
    one inner node, and no path from the root longer than MAX_STACK - 1
    nodes, so that the traversal's stack (one farther child pushed at most
    per level) cannot overflow.  It copies the tree to the host: the port
    calls it where a tree enters it (build_bvh, convert.py
    scene_from_numpy), not per render."""
    start, n_prims, right = (t.detach().to("cpu", torch.int64).numpy()
                             for t in (bvh.start, bvh.n_prims, bvh.right_offset))
    order = bvh.tri_order.detach().to("cpu", torch.int64).numpy()
    m = start.shape[0]
    if m == 0 or not np.array_equal(np.sort(order), np.arange(n_tri)):
        raise ValueError(f"the BVH's tri_order is not a permutation of {n_tri} triangles")
    leaf = n_prims > 0
    if (leaf & ((n_prims >= 1 << LEAF_BITS) | (start >= 1 << (31 - LEAF_BITS)))).any():
        raise ValueError(f"a BVH leaf does not fit the node table's leaf reference: more than "
                         f"{(1 << LEAF_BITS) - 1} triangles or a first slot past "
                         f"{(1 << (31 - LEAF_BITS)) - 1}")
    if (n_prims < 0).any() or (leaf & ((start < 0) | (start + n_prims > n_tri))).any():
        raise ValueError("a BVH leaf holds slots outside tri_order")
    inner = np.nonzero(~leaf)[0]
    if ((right[inner] < 2) | (inner + right[inner] >= m)).any():
        raise ValueError("a BVH inner node's children lie outside the node table")
    parents = np.bincount(np.concatenate([inner + 1, inner + right[inner]]), minlength=m)
    if parents[0] != 0 or (parents[1:] != 1).any():
        raise ValueError("a BVH node below the root is not the child of exactly one inner node")
    depth = np.zeros(m, dtype=np.int64)  # children follow their parent
    for i in inner:
        for c in (i + 1, i + right[i]):
            depth[c] = max(depth[c], depth[i] + 1)
    if int(depth.max()) + 1 > MAX_STACK:
        raise ValueError(f"the BVH is {int(depth.max()) + 1} nodes deep; the traversal's stack "
                         f"holds {MAX_STACK}")


def node_rows(bvh: BVHData) -> torch.Tensor:
    """(1 + I, 16) float32 node table of the kernels' traversal
    (render_common.cuh traverse), I the tree's inner nodes ((M - 1) / 2 in
    a tree that check_bvh passed), built on the tree's device.  Row 1 + j
    is the j-th inner node in depth-first order, 64 bytes: its children's
    boxes, padded as _padded_boxes pads them, and references, in the
    columns 0:3 left lo, 3:6 left hi, 6 left reference, 7 right
    reference, 8:11 right lo, 11:14 right hi, 14:16 zero.  Row 0 holds the
    root's box and reference in both children's places (the traversal
    reads the left).  A reference is, as int32 bits, an inner child's row,
    or a leaf's -2**31 + (first slot << LEAF_BITS | n_prims)."""
    lo, hi = _padded_boxes(bvh)
    m, inner = bvh.n_nodes, bvh.n_prims == 0
    rank = inner.cumsum(0)  # an inner node's row
    leaf = torch.add(bvh.n_prims, bvh.start, alpha=1 << LEAF_BITS) | -(1 << 31)
    ref = torch.where(inner, rank.int(), leaf)
    # Each node's box and reference as int32 bits, and a zero.
    src = torch.cat([lo.float().view(torch.int32), hi.float().view(torch.int32), ref[:, None]],
                    dim=1)
    src = torch.nn.functional.pad(src, (0, 1))
    # Each row's (left, right) node: (root, root) in row 0, an inner node's
    # children in its row; the leaves' land in a last row, left out.
    n_rows = (m + 1) // 2
    i = torch.arange(m, device=src.device)
    kids = torch.stack([i + 1, i + bvh.right_offset], dim=1)
    pairs = kids.new_zeros((n_rows + 1, 2)).index_copy_(0, torch.where(inner, rank, n_rows), kids)
    rows = src[pairs[:n_rows]]
    left, right = rows[:, 0], rows[:, 1]
    return torch.cat([left[:, :7], right[:, 6:7], right[:, :6], right[:, 7:], right[:, 7:]],
                     dim=1).view(torch.float32)


def _slab(lo, hi, p, inv_d, best_t):
    """(enters, t_min) of boxes (..., 3) against rays (..., 3): the ray's
    [0, inf) meets the box no later than best_t (JAX _slab_test; NaN from
    0 * inf misses, as there)."""
    l1 = (lo - p) * inv_d
    l2 = (hi - p) * inv_d
    t_min = torch.minimum(l1, l2).amax(dim=-1)
    t_max = torch.maximum(l1, l2).amin(dim=-1)
    return (t_max >= torch.clamp(t_min, min=0.0)) & (t_min <= best_t), t_min


def _tri_test(pl, p, d, min_dot, epsilon):
    """Distance to one triangle per (ray, slot) (plane rows pl (..., 16),
    rays (..., 3)), +inf where a test rejects: ops/intersect.py _t_masked's
    arithmetic, element by element."""
    proj = lambda j, v, w: ((v[..., 0] * pl[..., 4 * j] + v[..., 1] * pl[..., 4 * j + 1]
                             + v[..., 2] * pl[..., 4 * j + 2]) + (pl[..., 4 * j + 3] if w else 0.0))
    a0, b0 = proj(0, p, True), proj(0, d, False)
    t = a0 / (-b0)
    inside = (torch.abs(b0) >= min_dot) & (t >= epsilon)
    for j in (1, 2, 3):
        inside = inside & (proj(j, p, True) + t * proj(j, d, False) <= 0.0)
    return torch.where(inside, t, torch.full_like(t, float("inf")))


def intersect_bvh(
    scene: SceneData,
    bvh: BVHData,
    p: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    min_dot: float = 1e-4,
    epsilon: float = 1e-2,
) -> Intersection:
    """Closest hit of each ray by stack traversal of `bvh` (built on
    `scene` in its global triangle order), with intersect_planes' contract
    and results: exact ties keep the lowest triangle index.  A round pops
    one node per ray, tests a leaf's slots together (as many as the
    fullest leaf holds, whatever leaf size built the tree) and both
    children's boxes together.  Inside ops/intersect.py counting_sweeps it
    counts the kernel's work: the nodes visited (popped here), the (ray,
    box) tests (the root's, then both children's of each inner node
    entered: the kernel tests a box once, where this loop tests it again
    when it pops the node), the (ray, triangle) tests, and the visits
    culled because the ray enters the node's box past its closest hit (the
    pop's test here; the kernel's stored entry distance)."""
    n, dev = p.shape[0], p.device
    counts = _intersect._counts
    leaf_size = max(int(bvh.n_prims.max()), 1) if bvh.n_nodes else 1
    planes = plane_rows(scene)
    lo_box, hi_box = _padded_boxes(bvh)
    n_prims, start = bvh.n_prims.long(), bvh.start.long()
    right, order = bvh.right_offset.long(), bvh.tri_order.long()
    last_node, last_slot = bvh.n_nodes - 1, order.shape[0] - 1
    k = torch.arange(leaf_size, device=dev)
    t_out = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    tri_out = torch.zeros(n, dtype=torch.int64, device=dev)

    # The working set: rays whose stack is not empty, with their state.
    lane = torch.arange(n, device=dev)
    pa, da = p.contiguous(), d.contiguous()
    ia = 1.0 / da
    stack = torch.zeros((n, MAX_STACK), dtype=torch.int32, device=dev)  # the root, node 0
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    best_t = t_out.clone()
    best_tri = torch.full((n,), _NO_TRI, dtype=torch.int64, device=dev)
    if counts is not None:
        counts["node_tests"] += n  # the root's box
    root = True
    while lane.numel():
        sp = sp - 1
        node = stack.gather(1, sp[:, None])[:, 0].long()
        hit_box, _ = _slab(lo_box[node], hi_box[node], pa, ia, best_t)
        count = n_prims[node]
        # A leaf the ray meets: its slots' (t, triangle), lexicographically
        # least with the best so far (what testing them one by one with the
        # tie rule gives).
        take = (hit_box & (count > 0))[:, None] & (k[None, :] < count[:, None])
        tri = order[torch.clamp(start[node][:, None] + k[None, :], max=last_slot)]
        t = _tri_test(planes[tri], pa[:, None, :], da[:, None, :], min_dot, epsilon)
        inf = torch.full_like(t, float("inf"))
        cand_t = torch.cat([best_t[:, None], torch.where(take, t, inf)], dim=1)
        cand_tri = torch.cat([best_tri[:, None], torch.where(take, tri, _NO_TRI)], dim=1)
        best_t = cand_t.amin(dim=1)
        best_tri = torch.where(cand_t == best_t[:, None], cand_tri,
                               torch.full_like(cand_tri, _NO_TRI)).amin(dim=1)
        # An inner node whose box the ray meets pushes the children it
        # meets, the farther first, so that the nearer pops first.
        push = hit_box & (count == 0)
        if counts is not None:
            counts["nodes"] += lane.numel()
            counts["node_tests"] += 2 * int(push.sum())
            counts["tri_tests"] += int(take.sum())
            if not root:  # a pushed box failed only on t_min > best_t
                counts["culled"] += int((~hit_box).sum())
        root = False
        kids = torch.stack([torch.clamp(node + 1, max=last_node), node + right[node]], dim=1)
        hit_k, t_k = _slab(lo_box[kids], hi_box[kids], pa[:, None, :], ia[:, None, :],
                           best_t[:, None])
        near_left = t_k[:, 0] <= t_k[:, 1]
        for j in (torch.where(near_left, 1, 0), torch.where(near_left, 0, 1)):
            child = kids.gather(1, j[:, None])[:, 0]
            hit = push & hit_k.gather(1, j[:, None])[:, 0]
            slot = torch.clamp(sp, max=MAX_STACK - 1)[:, None]
            cur = stack.gather(1, slot)[:, 0]
            stack.scatter_(1, slot, torch.where(hit, child.to(torch.int32), cur)[:, None])
            sp = sp + hit.long()
        done = sp == 0
        n_done, deepest = (int(v) for v in torch.stack([done.sum(), sp.max()]).tolist())
        if deepest > MAX_STACK:
            raise RuntimeError(f"BVH traversal needs a stack deeper than {MAX_STACK}")
        if n_done:
            fin = lane[done]
            t_out[fin], tri_out[fin] = best_t[done], best_tri[done]
            keep = ~done
            lane, pa, da, ia = lane[keep], pa[keep], da[keep], ia[keep]
            stack, sp, best_t, best_tri = stack[keep], sp[keep], best_t[keep], best_tri[keep]
    hit = torch.isfinite(t_out)
    t_safe = torch.where(hit, t_out, torch.zeros_like(t_out))
    return Intersection(t=t_out, tri=torch.where(hit, tri_out, torch.zeros_like(tri_out)),
                        point=p + d * t_safe[:, None], hit=hit)

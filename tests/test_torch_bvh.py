"""The port's BVH (ops/bvh.py) on the CPU.

  * The structure of scene 0's tree (the JAX package's test_bvh_structure).
  * intersect_bvh against intersect_brute and against the JAX package's
    intersect_bvh on scene 0 (random rays from inside the box and rays from
    the camera) and on the large scene's 1280-triangle sphere: hit and tri
    equal, t rtol 1e-5; against the dense sweep (intersect_fast) bit for
    bit, since it repeats that sweep's triangle test.
  * Trees of other leaf sizes: the traversal tests every slot of a leaf.
  * Ties: coincident triangles give the lowest triangle index, as the sweep.
  * The kernels' node table (node_rows) on scene 0 and the large scene:
    each inner row holds its children's padded boxes and references, and
    the references reach every inner row and every leaf once; check_bvh
    refuses a leaf past the reference's bits.
  * intersect_bvh's four counts against a transcription of the kernels'
    traversal (render_common.cuh traverse) on that table, which gives its
    hits too, and against one of the traversal before it (every pop
    re-tests its box): the same nodes and triangle tests, box tests fewer
    by the pops after the root, and rays + 2 x inner nodes entered.
  * A scene with a BVH renders as without it under intersect "auto", its
    gradient too (the kernels' permuted view drops the BVH); SceneData.to
    and scene_from_numpy carry it; load_scene(with_bvh=True) attaches it.
    The BVH route (intersect="bvh") is tests/test_torch_bvh_route.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.ops import bvh as jbvh
from inverse_path_tracer_tpu.scene.build import build_scene as jax_build_scene
from inverse_path_tracer_tpu.scene.dsl import ObjectParams as JaxObject

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import (
    ASSET_ROOT,
    RenderConfig,
    build_scene,
    large_scene,
    load_scene,
    render_samples,
)
from inverse_path_tracer_torch.assets import SPHERE_RINGS, SPHERE_SEGMENTS
from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
from inverse_path_tracer_torch.convert import jax_scene_fields, scene_from_numpy
from inverse_path_tracer_torch.ops.bvh import (
    LEAF_BITS,
    BVHData,
    _padded_boxes,
    _tri_test,
    attach_bvh,
    build_bvh,
    check_bvh,
    intersect_bvh,
    node_rows,
)
from inverse_path_tracer_torch.ops.intersect import (
    counting_sweeps,
    intersect_brute,
    intersect_fast,
    plane_rows,
)
from inverse_path_tracer_torch.ops.kernels.clusters import kernel_view
from inverse_path_tracer_torch.scene.dsl import ObjectParams
from test_torch_forward import SCENE0

CPU = dict(device="cpu")


def random_rays(n, seed, origin=(0, 0, 0), spread=1.0):
    """The JAX package's tests/test_bvh.py _random_rays, as numpy arrays."""
    g = np.random.default_rng(seed)
    p = (g.uniform(-spread, spread, size=(n, 3)) + np.asarray(origin)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d.astype(np.float32)


def camera_like_rays(n, seed):
    """Rays from the eye into the box (the JAX test_bvh_matches_brute_from_camera)."""
    _, d = random_rays(n, seed)
    d = np.stack([d[:, 0] * 0.5, d[:, 1] * 0.5, np.abs(d[:, 2]) + 0.5], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.zeros((n, 3), np.float32), d.astype(np.float32)


def sphere_scenes(tmp_path):
    obj = tmp_path / "sphere.obj"
    obj.write_text(sphere_obj_text(SPHERE_RINGS, SPHERE_SEGMENTS, normals=True))
    js = jax_build_scene([JaxObject(pos=(0, 0, 4), obj_file=str(obj),
                                    mtl_file="*Kd 0.5 0.5 0.5*")])
    return js, scene_from_numpy(jax_scene_fields(js))


def assert_hits_equal(want, got, exact=False):
    hw, hg = np.asarray(want.hit), np.asarray(got.hit)
    np.testing.assert_array_equal(hg, hw)
    np.testing.assert_array_equal(np.asarray(got.tri)[hw], np.asarray(want.tri)[hw])
    if exact:
        np.testing.assert_array_equal(np.asarray(got.t), np.asarray(want.t))
    else:
        np.testing.assert_allclose(np.asarray(got.t)[hw], np.asarray(want.t)[hw], rtol=1e-5)
    assert hw.sum() > 0


@pytest.fixture(scope="module")
def scene0():
    js = jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    return js, scene_from_numpy(jax_scene_fields(js))


def test_bvh_structure(scene0):
    _, ts = scene0
    bvh = build_bvh(ts)
    assert sorted(bvh.tri_order.tolist()) == list(range(30))
    leaves = bvh.n_prims > 0
    assert int(bvh.n_prims[leaves].sum()) == 30 and bool((bvh.n_prims[leaves] <= 4).all())
    np.testing.assert_allclose(bvh.bbox_min[0].numpy(), [-2, -2, 2], atol=1e-5)
    np.testing.assert_allclose(bvh.bbox_max[0].numpy(), [2, 2, 6], atol=1e-5)
    # depth-first: a node's left child follows it; right children lie ahead
    inner = (~leaves).nonzero().flatten()
    assert bool((bvh.right_offset[inner] > 1).all()) and bool((bvh.right_offset[leaves] == 0).all())


RAYS = {"random": lambda: random_rays(512, 0, origin=(0, 0, 4), spread=1.8),
        "camera": lambda: camera_like_rays(256, 1)}


@pytest.mark.parametrize("kind", sorted(RAYS))
def test_bvh_matches_brute_and_jax_on_scene0(scene0, kind):
    js, ts = scene0
    p, d = RAYS[kind]()
    tp, td = torch.from_numpy(p), torch.from_numpy(d)
    got = intersect_bvh(ts, build_bvh(ts), tp, td)
    assert_hits_equal(intersect_brute(ts, tp, td), got)
    assert_hits_equal(intersect_fast(ts, tp, td), got, exact=True)
    assert_hits_equal(jbvh.intersect_bvh(js, jbvh.build_bvh(js), jnp.asarray(p), jnp.asarray(d)),
                      got)


def test_bvh_matches_brute_and_jax_on_the_sphere(tmp_path):
    js, ts = sphere_scenes(tmp_path)
    assert ts.n_tri == 1280
    bvh = build_bvh(ts)
    assert bvh.n_nodes > 100
    p, d = random_rays(256, 2, origin=(0, 0, 4), spread=2.0)
    tp, td = torch.from_numpy(p), torch.from_numpy(d)
    got = intersect_bvh(ts, bvh, tp, td)
    assert_hits_equal(intersect_brute(ts, tp, td), got)
    assert_hits_equal(intersect_fast(ts, tp, td), got, exact=True)
    assert_hits_equal(jbvh.intersect_bvh(js, jbvh.build_bvh(js), jnp.asarray(p), jnp.asarray(d)),
                      got)


def test_bvh_matches_the_sweep_on_the_large_scene():
    scene = large_scene()
    p, d = random_rays(2048, 3, origin=(0, 0, 4), spread=1.9)
    tp, td = torch.from_numpy(p), torch.from_numpy(d)
    assert_hits_equal(intersect_fast(scene, tp, td), intersect_bvh(scene, build_bvh(scene), tp, td),
                      exact=True)


@pytest.mark.parametrize("leaf_size", [1, 2, 8, 16])
def test_bvh_of_any_leaf_size_matches_brute(leaf_size):
    """The traversal tests as many slots as the fullest leaf holds, so a
    tree built with leaves larger than the default loses no triangle."""
    scene = large_scene()
    bvh = build_bvh(scene, leaf_size=leaf_size)
    assert int(bvh.n_prims.max()) == leaf_size
    p, d = random_rays(1024, 5, origin=(0, 0, 4), spread=1.9)
    tp, td = torch.from_numpy(p), torch.from_numpy(d)
    got = intersect_bvh(scene, bvh, tp, td)
    assert_hits_equal(intersect_brute(scene, tp, td), got)
    assert_hits_equal(intersect_fast(scene, tp, td), got, exact=True)
    attached = attach_bvh(scene, leaf_size=leaf_size)
    assert_hits_equal(got, intersect_bvh(attached, attached.bvh, tp, td), exact=True)


def test_ties_keep_the_lowest_triangle_index():
    """Three coincident copies of the cube (triangles 18-29, 30-41, 42-53):
    a ray that hits the cube hits all three at the same t."""
    box = ObjectParams(pos=(0, 0, 4), scl=(2, 2, 2), obj_file="CornellBox/CornellBox-Empty-CO.obj",
                       mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    cube = ObjectParams(pos=(0, -1.5, 4), obj_file="shapes/cube.obj", mtl_file="*Kd 0.5 0.5 0.5*")
    scene = build_scene([box, cube, cube, cube], asset_root=ASSET_ROOT)
    assert scene.n_tri == 18 + 3 * 12
    p, d = camera_like_rays(2048, 4)
    tp, td = torch.from_numpy(p), torch.from_numpy(d)
    want = intersect_fast(scene, tp, td)
    got = intersect_bvh(scene, build_bvh(scene), tp, td)
    assert_hits_equal(want, got, exact=True)
    on_cube = got.hit & (got.tri >= 18)
    assert int(on_cube.sum()) > 20 and bool((got.tri[on_cube] < 30).all())


def test_a_scene_with_a_bvh_renders_as_without_it():
    """With intersect "auto" the renders do not read the BVH; the clustered
    view permutes the triangles and drops it."""
    plain = large_scene()
    scene = attach_bvh(plain)
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=4, tile_size=64)
    clustered = kernel_view(scene, cfg)
    assert clustered.perm is not None and clustered.scene.bvh is None
    a, sa = render_samples(plain.diffuse, plain, 3, cfg, **CPU)  # clustered, staged
    b, sb = render_samples(scene.diffuse, scene, 3, cfg, **CPU)
    assert torch.equal(a, b) and int(sa.segments) == int(sb.segments)
    tonemap = lambda v: (v.reshape(-1, cfg.spp, 3).mean(1)).sum()
    grads = []
    for s in (plain, scene):
        kd = s.diffuse.clone().requires_grad_()
        tonemap(render_samples(kd, s, 3, cfg, **CPU)[0]).backward()
        grads.append(kd.grad)
    assert torch.equal(grads[0], grads[1]) and float(grads[0].abs().max()) > 0


def test_scene_data_to_and_numpy_carry_the_bvh(scene0):
    js, ts = scene0
    assert ts.bvh is None and ts.to("meta").bvh is None
    b = attach_bvh(ts)
    moved = b.to("meta")
    assert isinstance(moved.bvh, BVHData) and moved.bvh.start.device.type == "meta"
    assert b.to("cpu").bvh.n_nodes == b.bvh.n_nodes
    carried = scene_from_numpy(jax_scene_fields(jbvh.attach_bvh(js)))
    for name in BVHData._fields:
        assert torch.equal(getattr(carried.bvh, name), getattr(b.bvh, name)), name
    # the comprehension of np.asarray over the leaves still works without a BVH
    plain = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})
    assert plain.bvh is None


def test_load_scene_with_bvh_attaches_it():
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT, with_bvh=True)
    assert isinstance(scene.bvh, BVHData)
    want = build_bvh(load_scene(SCENE0, asset_root=ASSET_ROOT))
    for name in BVHData._fields:
        assert torch.equal(getattr(scene.bvh, name), getattr(want, name)), name


def decode(ref):
    """("inner", row) or ("leaf", first slot, count) of a node table reference."""
    if ref >= 0:
        return ("inner", ref)
    code = ref & 0x7FFFFFFF
    return ("leaf", code >> LEAF_BITS, code & ((1 << LEAF_BITS) - 1))


def ref_of(bvh, node):
    """What a reference to `node` of `bvh` decodes to: its table row (1 +
    its rank among the inner nodes) or its slots."""
    n_prims = bvh.n_prims.tolist()
    if n_prims[node]:
        return ("leaf", int(bvh.start[node]), n_prims[node])
    return ("inner", 1 + sum(1 for c in n_prims[:node] if c == 0))


@pytest.mark.parametrize("which", ["scene0", "large"])
def test_node_rows_pair_the_children(scene0, which):
    """Row 1 + j holds the j-th inner node's children: their boxes as
    _padded_boxes pads them and a reference to each; row 0 the root's box
    and reference, twice.  Walking the references from row 0 reaches every
    inner row and every leaf exactly once."""
    scene = scene0[1] if which == "scene0" else large_scene()
    bvh = build_bvh(scene)
    rows = node_rows(bvh)
    bits = rows.view(torch.int32)
    inner = (bvh.n_prims == 0).nonzero().flatten().tolist()
    assert rows.shape == (1 + len(inner), 16) and rows.dtype == torch.float32
    assert rows.is_contiguous() and len(inner) == (bvh.n_nodes - 1) // 2
    lo, hi = _padded_boxes(bvh)
    box = torch.cat([lo, hi], dim=1)
    assert torch.equal(rows[0, 0:6], box[0]) and decode(int(bits[0, 6])) == ref_of(bvh, 0)
    assert torch.equal(rows[0, 8:14], box[0]) and int(bits[0, 7]) == int(bits[0, 6])
    assert not bits[0, 14:].any()
    for j, node in enumerate(inner):
        left, right = node + 1, node + int(bvh.right_offset[node])
        row, row_bits = rows[1 + j], bits[1 + j]
        assert torch.equal(row[0:6], box[left]) and torch.equal(row[8:14], box[right])
        assert decode(int(row_bits[6])) == ref_of(bvh, left)
        assert decode(int(row_bits[7])) == ref_of(bvh, right)
        assert not row_bits[14:].any()
    seen_rows, seen_leaves = [], []
    todo = [int(bits[0, 6])]
    while todo:
        ref = decode(todo.pop())
        if ref[0] == "leaf":
            seen_leaves.append(ref[1:])
        else:
            seen_rows.append(ref[1])
            todo += [int(bits[ref[1], 6]), int(bits[ref[1], 7])]
    leaves = bvh.n_prims > 0
    want = sorted(zip(bvh.start[leaves].tolist(), bvh.n_prims[leaves].tolist()))
    assert sorted(seen_rows) == list(range(1, 1 + len(inner)))
    assert sorted(seen_leaves) == want
    slots = sorted(s for start, count in want for s in range(start, start + count))
    assert slots == list(range(scene.n_tri))


@pytest.mark.parametrize("past", ["count", "start"])
def test_check_bvh_refuses_leaves_past_the_reference(past):
    """A leaf reference holds 31 - LEAF_BITS bits of first slot and
    LEAF_BITS of triangle count; check_bvh refuses a tree beyond them."""
    if past == "count":
        scene = large_scene()
        build_bvh(scene, leaf_size=(1 << LEAF_BITS) - 1)
        with pytest.raises(ValueError, match="leaf reference"):
            build_bvh(scene, leaf_size=1 << LEAF_BITS)
        return
    one = torch.ones((1, 3))
    leaf = BVHData(-one, one, torch.tensor([1 << (31 - LEAF_BITS)], dtype=torch.int32),
                   torch.tensor([1], dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="leaf reference"):
        check_bvh(leaf, 1)
    check_bvh(leaf._replace(start=torch.zeros(1, dtype=torch.int32)), 1)


def slab1(lo, hi, p, inv, best):
    """ops/bvh.py _slab of one box and one ray, in float32."""
    l1, l2 = (lo - p) * inv, (hi - p) * inv
    t_min = np.minimum(l1, l2).max()
    t_max = np.maximum(l1, l2).min()
    return bool((t_max >= np.maximum(t_min, np.float32(0))) & (t_min <= best)), t_min


class OneRay:
    """One ray's closest hit over leaves of `bvh` (intersect_bvh's triangle
    test, ties to the lower global index) and its work counts."""

    def __init__(self, scene, bvh, p, d):
        self.planes, self.order = plane_rows(scene), bvh.tri_order.long()
        self.p, self.d = p, d
        self.tp, self.td = torch.from_numpy(p)[None], torch.from_numpy(d)[None]
        self.inv = (np.float32(1) / d).astype(np.float32)
        self.t, self.tri = np.float32(np.inf), 1 << 30
        self.c = dict(nodes=0, node_tests=0, tri_tests=0, culled=0, pops=0)

    def slab(self, lo, hi):
        self.c["node_tests"] += 1
        return slab1(lo, hi, self.p, self.inv, self.t)

    def leaf(self, start, count):
        self.c["tri_tests"] += count
        tri = self.order[start:start + count]
        t = _tri_test(self.planes[tri], self.tp, self.td, 1e-4, 1e-2).numpy()
        for tk, g in zip(t.tolist(), tri.tolist()):
            if (tk, g) < (float(self.t), self.tri):
                self.t, self.tri = np.float32(tk), g


def traverse_popping(scene, bvh, p, d):
    """The traversal before the pair rows, one ray: pop a node, test its box
    (again), then a leaf's triangles or both children's boxes, pushing
    those the ray enters, the farther first."""
    r = OneRay(scene, bvh, p, d)
    lo, hi = (b.numpy() for b in _padded_boxes(bvh))
    n_prims, start, right = bvh.n_prims.tolist(), bvh.start.tolist(), bvh.right_offset.tolist()
    stack = [0]
    while stack:
        node = stack.pop()
        r.c["pops"] += 1
        hit, _ = r.slab(lo[node], hi[node])
        if not hit:
            continue
        if n_prims[node]:
            r.leaf(start[node], n_prims[node])
            continue
        kids = (node + 1, node + right[node])
        (h_l, t_l), (h_r, t_r) = (r.slab(lo[k], hi[k]) for k in kids)
        near, far = (0, 1) if t_l <= t_r else (1, 0)
        for k, h in ((far, (h_l, h_r)[far]), (near, (h_l, h_r)[near])):
            if h:
                stack.append(kids[k])
    return r


def traverse_pairs(scene, bvh, rows, p, d):
    """render_common.cuh traverse on node_rows' table, one ray (its 1 / d
    is intersect_bvh's, not inv_component's)."""
    pop = -(1 << 31)  # kPop, a leaf reference of 0 triangles
    r = OneRay(scene, bvh, p, d)
    bits = rows.view(torch.int32).tolist()
    rows = rows.numpy()
    r.c["nodes"] += 1
    hit, _ = r.slab(rows[0, 0:3], rows[0, 3:6])
    if not hit:
        return r
    ref, stack = bits[0][6], []
    while True:
        if ref >= 0:
            row, (left, right) = rows[ref], bits[ref][6:8]
            h_l, t_l = r.slab(row[0:3], row[3:6])
            h_r, t_r = r.slab(row[8:11], row[11:14])
            r.c["nodes"] += h_l + h_r
            near_left = t_l <= t_r
            if h_l and h_r:
                stack.append((right if near_left else left, max(t_l, t_r)))
            ref = pop if not (h_l or h_r) else (
                left if (near_left if h_l and h_r else h_l) else right)
        else:
            _, first, count = decode(ref)
            r.leaf(first, count)
            ref = pop
        if ref == pop:
            if not stack:
                return r
            e_ref, t_in = stack.pop()
            if t_in <= r.t:
                ref = e_ref
            else:
                r.c["culled"] += 1


@pytest.mark.parametrize("kind", ["box", "camera"])
def test_intersect_bvh_counts_the_pair_step(kind):
    """On the large scene: intersect_bvh's four counts are those of the
    kernels' traversal (transcribed, on node_rows' table, with its hits
    equal); its nodes and triangle tests those of the traversal that
    re-tested every popped box, its box tests fewer by the pops after the
    root: rays + 2 x inner nodes entered; culled visits at most the nodes."""
    scene = large_scene()
    bvh = build_bvh(scene)
    rows = node_rows(bvh)
    n = 192
    p, d = (random_rays(n, 8, origin=(0, 0, 4), spread=1.9) if kind == "box"
            else camera_like_rays(n, 9))
    with counting_sweeps() as c:
        got = intersect_bvh(scene, bvh, torch.from_numpy(p), torch.from_numpy(d))
    old, new = {}, {}
    for i in range(n):
        a, b = traverse_popping(scene, bvh, p[i], d[i]), traverse_pairs(scene, bvh, rows, p[i], d[i])
        for key in a.c:
            old[key] = old.get(key, 0) + a.c[key]
            new[key] = new.get(key, 0) + b.c[key]
        assert float(b.t) == float(got.t[i]) and (not got.hit[i] or b.tri == int(got.tri[i]))
        assert float(a.t) == float(b.t) and a.tri == b.tri
    assert int(got.hit.sum()) > n // 2
    mine = {k: c[k] for k in ("nodes", "node_tests", "tri_tests", "culled")}
    assert mine == {k: new[k] for k in mine}
    assert c["nodes"] == old["pops"] and c["tri_tests"] == old["tri_tests"]
    assert c["node_tests"] == old["node_tests"] - (old["pops"] - n)
    inner_entered = (c["node_tests"] - n) // 2
    assert c["node_tests"] == n + 2 * inner_entered and 0 < c["culled"] <= c["nodes"]
    assert c["node_tests"] < old["node_tests"] and c["culled"] > 0

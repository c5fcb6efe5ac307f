"""The port's BVH (ops/bvh.py) on the CPU.

  * The structure of scene 0's tree (the JAX package's test_bvh_structure).
  * intersect_bvh against intersect_brute and against the JAX package's
    intersect_bvh on scene 0 (random rays from inside the box and rays from
    the camera) and on the large scene's 1280-triangle sphere: hit and tri
    equal, t rtol 1e-5; against the dense sweep (intersect_fast) bit for
    bit, since it repeats that sweep's triangle test.
  * Trees of other leaf sizes: the traversal tests every slot of a leaf.
  * Ties: coincident triangles give the lowest triangle index, as the sweep.
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
from inverse_path_tracer_torch.ops.bvh import BVHData, attach_bvh, build_bvh, intersect_bvh
from inverse_path_tracer_torch.ops.intersect import intersect_brute, intersect_fast
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

"""The port's scene assets: the scene-0 fixture (CornellBox/, shapes/, made
by make_fixture.py), large_scene(), the large-scene workload, and
bvh_scene(), the BVH route's scene."""

from __future__ import annotations

import os
import tempfile

SPHERE_RINGS, SPHERE_SEGMENTS = 21, 32  # 2 * 32 * 20 = 1280 triangles
BVH_SPHERE_RINGS, BVH_SPHERE_SEGMENTS = 81, 128  # 2 * 128 * 80 = 20480 triangles


def _box_and_sphere(rings: int, segments: int, vertex_normals: bool):
    """The Cornell box at (0, 0, 4), scale 2, plus a generated lat-long
    sphere (make_fixture.sphere_obj_text) at (0, -1.5, 4) with Kd 0.5, on
    the CPU."""
    from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
    from inverse_path_tracer_torch.scene.build import ASSET_ROOT, build_scene
    from inverse_path_tracer_torch.scene.dsl import ObjectParams

    box = ObjectParams(pos=(0, 0, 4), scl=(2, 2, 2),
                       obj_file="CornellBox/CornellBox-Empty-CO.obj",
                       mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "sphere.obj")
        with open(obj, "w") as f:
            f.write(sphere_obj_text(rings, segments, normals=vertex_normals))
        ball = ObjectParams(pos=(0, -1.5, 4), obj_file=obj, mtl_file="*Kd 0.5 0.5 0.5*")
        return build_scene([box, ball], asset_root=ASSET_ROOT)


def large_scene(device=None, vertex_normals: bool = True):
    """The JAX package's large-scene workload (its tests/test_pallas.py
    _sphere_scene, scripts/bench_scene.py sphere): the Cornell box at (0, 0,
    4), scale 2, plus a lat-long sphere of 1280 triangles at (0, -1.5, 4)
    with Kd 0.5, 1298 triangles in all.  The sphere is generated
    (make_fixture.sphere_obj_text), with vertex normals or, when
    vertex_normals=False, flat.  device=None leaves the scene on the CPU."""
    scene = _box_and_sphere(SPHERE_RINGS, SPHERE_SEGMENTS, vertex_normals)
    return scene if device is None else scene.to(device)


def bvh_scene(device=None, use_native: bool = False):
    """The BVH route's scene: large_scene()'s box plus a vertex-normal
    lat-long sphere of 20,480 triangles (81 rings, 128 segments) in its
    place, 20,498 triangles, with its BVH attached (ops/bvh.py build_bvh;
    use_native=True asks for the C++ builder, same arrays).  At this size
    the JAX package offers only its BVH route for a render and its
    gradient.  device=None leaves the scene on the CPU."""
    from inverse_path_tracer_torch.ops.bvh import build_bvh

    scene = _box_and_sphere(BVH_SPHERE_RINGS, BVH_SPHERE_SEGMENTS, True)
    scene = scene.replace(bvh=build_bvh(scene, use_native=use_native))
    return scene if device is None else scene.to(device)

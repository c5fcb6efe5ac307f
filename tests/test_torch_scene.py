"""The port's scene front end against the JAX package's, on the in-repo
scene-0 fixture.  Tolerance: rtol 1e-6 on every SceneData field (both
builders run the same float64/float32 host arithmetic, so in practice the
arrays are equal).  The scene-text writers give the JAX package's strings
and files, character for character."""

import dataclasses
import os

import numpy as np
import pytest

import inverse_path_tracer_tpu.scene.build as jbuild
import inverse_path_tracer_tpu.scene.dsl as jdsl
from inverse_path_tracer_tpu.scene.dsl import ObjectParams as JObjectParams
from inverse_path_tracer_tpu.scene.dsl import object_from_string as j_object_from_string

import torch_threads  # noqa: F401

import inverse_path_tracer_torch.scene.dsl as tdsl
from inverse_path_tracer_torch import ASSET_ROOT, SceneData, build_scene, load_scene
from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
from inverse_path_tracer_torch.convert import materials_from_numpy, scene_from_numpy
from inverse_path_tracer_torch.scene.dsl import ObjectParams, load_params, object_from_string

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
RTOL = 1e-6


def assert_scenes_equal(jscene, tscene):
    for f in dataclasses.fields(SceneData):
        if f.name == "bvh":  # JAX's () is the port's None; else the six arrays
            jb, tb = jscene.bvh, tscene.bvh
            assert (len(jb) == 0) == (tb is None), f.name
            pairs = [] if tb is None else list(zip(jb, tb))
        else:
            pairs = [(getattr(jscene, f.name), getattr(tscene, f.name))]
        for a, b in pairs:
            a, b = np.asarray(a), b.cpu().numpy()
            assert a.shape == b.shape, f.name
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0, err_msg=f.name)


def test_fixture_matches_jax_load_scene():
    assert_scenes_equal(
        jbuild.load_scene(SCENE0, asset_root=ASSET_ROOT),
        load_scene(SCENE0, asset_root=ASSET_ROOT),
    )


def test_fixture_materials_and_geometry():
    s = load_scene(SCENE0, asset_root=ASSET_ROOT)
    labels = np.load(os.path.join(REPO, "artifacts/exp100/data.npz"))["labels"][0]
    np.testing.assert_allclose(s.diffuse.numpy(), labels, rtol=RTOL)
    assert s.n_tri == 30
    assert s.emissive_idx.tolist() == [16, 17]
    np.testing.assert_allclose(s.emission[16].numpy(), (10, 10, 10))
    np.testing.assert_allclose(s.emission[:16].numpy(), 0)
    # Light faces down, floor up; the mesh matches mesh.ply in world space.
    np.testing.assert_allclose(s.face_normal[16].numpy(), (0, -1, 0), atol=1e-7)
    np.testing.assert_allclose(s.face_normal[0].numpy(), (0, 1, 0), atol=1e-7)
    np.testing.assert_allclose(s.area[16].numpy(), 2.0, rtol=RTOL)
    assert not s.has_vertex_normals and s.specular_idx.numel() == 0


def test_inline_kd_object_matches_jax():
    text = ("POS 0.0 -1.5 4.0\nOBJ ./shapes/cube.obj\n"
            "MTL *Kd 0.25 0.5 0.75*\n")
    tp = object_from_string(text)
    jp = j_object_from_string(text)
    assert dataclasses.asdict(tp) == jp.__dict__
    ts = build_scene([tp], asset_root=ASSET_ROOT)
    np.testing.assert_allclose(ts.diffuse.numpy(), np.tile([0.25, 0.5, 0.75], (12, 1)))
    assert_scenes_equal(jbuild.build_scene([jp], asset_root=ASSET_ROOT), ts)


def test_specular_mtl_matches_jax(tmp_path):
    mtl = tmp_path / "spec.mtl"
    mtl.write_text("newmtl cube\nKd 0.5 0.3 0.2\nKs 0.4 0.4 0.4\nNs 16\n")
    kw = dict(pos=(0, -1.5, 4), obj_file="shapes/cube.obj", mtl_file=str(mtl))
    ts = build_scene([ObjectParams(**kw)], asset_root=ASSET_ROOT)
    assert ts.specular_idx.tolist() == list(range(12))
    np.testing.assert_allclose(ts.shininess.numpy(), 16.0)
    assert_scenes_equal(jbuild.build_scene([JObjectParams(**kw)], asset_root=ASSET_ROOT), ts)


def test_vertex_normal_scene_matches_jax(tmp_path):
    obj = tmp_path / "sphere.obj"
    obj.write_text(sphere_obj_text(rings=6, segments=8))
    box = dict(pos=(0, 0, 4), scl=(2, 2, 2), obj_file="CornellBox/CornellBox-Empty-CO.obj",
               mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    ball = dict(pos=(0, -1.5, 4), ori=(0.3, 0.0, 0.2), obj_file=str(obj),
                mtl_file="*Kd 0.5 0.5 0.5*")
    ts = build_scene([ObjectParams(**box), ObjectParams(**ball)], asset_root=ASSET_ROOT)
    assert ts.has_vertex_normals and ts.n_tri == 18 + 2 * 8 * 5
    js = jbuild.build_scene([JObjectParams(**box), JObjectParams(**ball)], asset_root=ASSET_ROOT)
    assert_scenes_equal(js, ts)


def test_load_params_and_scene_from_numpy():
    assert [dataclasses.asdict(p) for p in load_params(SCENE0)] == [
        p.__dict__ for p in jbuild.load_params(SCENE0)
    ]
    js = jbuild.load_scene(SCENE0, asset_root=ASSET_ROOT)
    carried = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})
    assert_scenes_equal(js, carried)
    assert_scenes_equal(js, carried.to("cpu"))
    mats = materials_from_numpy(np.asarray(js.diffuse))
    assert mats.dtype == carried.diffuse.dtype and bool((mats == carried.diffuse).all())
    with pytest.raises(ValueError, match="nT, 3"):
        materials_from_numpy(np.zeros((30, 4)))


def test_object_without_mtl_raises():
    with pytest.raises(ValueError, match="OBJ and MTL"):
        object_from_string("POS 0 0 0\nOBJ ./shapes/cube.obj\n")


@pytest.mark.parametrize("mtl_file", [None, "./shapes/other.mtl"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dsl_writers_match_jax(seed, mtl_file):
    want = jdsl.standard_scene_string(np.random.default_rng(seed), mtl_file=mtl_file)
    got = tdsl.standard_scene_string(np.random.default_rng(seed), mtl_file=mtl_file)
    assert got == want
    assert tdsl.rand_mtl(np.random.default_rng(seed)) == jdsl.rand_mtl(np.random.default_rng(seed))
    if mtl_file is None:
        assert got.endswith(tdsl.rand_mtl(np.random.default_rng(seed)) + "\n")


@pytest.mark.parametrize("kw", [
    dict(shp=tdsl.SPHERE, ori=(0.1, 0.2, 0.3)),
    dict(shp=tdsl.CUBE, pos=(1, 2, 3), scl=(0.5, 0.5, 0.5), mtl_file="*Kd 0.1 0.2 0.3*"),
    dict(shp=tdsl.CORNELL, pos=(0, 0, 4)),
    dict(shp=tdsl.OTHER, obj_file="a.obj", mtl_file="a.mtl"),
    dict(obj_file="b.obj", mtl_file="b.mtl", pos=(0.25, 0, -1)),
])
def test_object_to_string_matches_jax(kw):
    got = tdsl.object_to_string(rng=np.random.default_rng(7), **kw)
    assert got == jdsl.object_to_string(rng=np.random.default_rng(7), **kw)
    assert dataclasses.asdict(object_from_string(got)) == j_object_from_string(got).__dict__


def test_object_to_string_without_files_raises():
    with pytest.raises(ValueError, match="OBJ and an MTL"):
        tdsl.object_to_string(shp=tdsl.OTHER, obj_file="a.obj")


def test_generate_scene_files_are_the_jax_files(tmp_path):
    want = jdsl.generate_scene_files(3, out_dir=str(tmp_path / "j"), seed=11)
    got = tdsl.generate_scene_files(3, out_dir=str(tmp_path / "t"), seed=11)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()

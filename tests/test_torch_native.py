"""The port's native bridge (utils/native.py) against its Python paths and
the JAX package's builder, on the CPU: OBJ parses and BVH builds must be
identical, array for array.

  * native and Python load_obj on every OBJ of the port's assets and on the
    generated vertex-normal sphere; a missing file raises FileNotFoundError;
  * native and Python build_bvh on scene 0 and on assets.large_scene(), and
    both against the JAX package's build_bvh(use_native=False) on the JAX
    scene carried across by convert.scene_from_numpy;
  * the Python paths are the default; without a toolchain use_native=True
    falls back to them, with the same arrays, and the build error is kept.
"""

import glob
import os

import numpy as np
import pytest
import torch

from inverse_path_tracer_tpu.ops import bvh as jbvh
from inverse_path_tracer_tpu.scene.build import load_scene as jax_load_scene

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, large_scene, load_scene
from inverse_path_tracer_torch.assets import SPHERE_RINGS, SPHERE_SEGMENTS
from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
from inverse_path_tracer_torch.convert import jax_scene_fields, scene_from_numpy
from inverse_path_tracer_torch.ops.bvh import BVHData, build_bvh
from inverse_path_tracer_torch.scene import obj_loader
from inverse_path_tracer_torch.utils import native
from test_torch_cluster import jax_large_scene
from test_torch_forward import SCENE0

ASSET_OBJS = sorted(glob.glob(os.path.join(ASSET_ROOT, "**", "*.obj"), recursive=True))


def test_native_library_builds():
    assert native.native_available(), native.build_error()
    assert native.build_error() is None
    assert os.path.exists(native.library_path())


def assert_meshes_equal(py, nat):
    np.testing.assert_array_equal(py.vertices, nat.vertices)
    np.testing.assert_array_equal(py.normals, nat.normals)
    np.testing.assert_array_equal(py.faces, nat.faces)
    np.testing.assert_array_equal(py.face_normals_idx, nat.face_normals_idx)
    assert py.material_names == nat.material_names
    assert py.mtllibs == nat.mtllibs


@pytest.mark.parametrize("path", ASSET_OBJS + ["sphere"],
                         ids=lambda p: os.path.relpath(p, ASSET_ROOT) if p != "sphere" else p)
def test_obj_native_matches_python(path, tmp_path):
    if path == "sphere":
        path = str(tmp_path / "sphere.obj")
        with open(path, "w") as f:
            f.write(sphere_obj_text(SPHERE_RINGS, SPHERE_SEGMENTS, normals=True))
    py = obj_loader.load_obj(path, use_native=False)
    assert_meshes_equal(py, native.load_obj_native(path))
    assert_meshes_equal(py, obj_loader.load_obj(path, use_native=True))


def test_asset_objs_found():
    names = {os.path.basename(p) for p in ASSET_OBJS}
    assert {"CornellBox-Empty-CO.obj", "cube.obj"} <= names


def test_obj_native_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.load_obj_native(str(tmp_path / "missing.obj"))


def assert_bvh_equal(a: BVHData, b: BVHData):
    for name in BVHData._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


SCENES = {"scene0": lambda: load_scene(SCENE0, asset_root=ASSET_ROOT), "large": large_scene}


@pytest.mark.parametrize("which", sorted(SCENES))
def test_bvh_native_matches_python(which):
    scene = SCENES[which]()
    py = build_bvh(scene, use_native=False)
    assert_bvh_equal(py, build_bvh(scene, use_native=True))
    assert_bvh_equal(py, BVHData.from_numpy(native.build_bvh_native(scene.vertices.numpy())))
    assert py.n_nodes > (100 if which == "large" else 5)


@pytest.mark.parametrize("which", ["scene0", "large"])
def test_bvh_builds_match_jax(which, tmp_path):
    js = (jax_load_scene(SCENE0, asset_root=ASSET_ROOT) if which == "scene0"
          else jax_large_scene(tmp_path))
    want = jbvh.build_bvh(js, use_native=False)
    ts = scene_from_numpy(jax_scene_fields(js))
    for use_native in (False, True):
        got = build_bvh(ts, use_native=use_native)
        for name in BVHData._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)


def test_python_is_the_default(monkeypatch):
    calls = []
    monkeypatch.setattr(native, "build_bvh_native", lambda *a: calls.append(a))
    monkeypatch.setattr(native, "load_obj_native", lambda *a: calls.append(a))
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)  # parses its OBJs by default
    build_bvh(scene)
    obj_loader.load_obj(ASSET_OBJS[0])
    assert calls == []


def test_without_a_toolchain_the_python_paths_give_the_same(monkeypatch, tmp_path):
    """A failed build keeps its error and the consumers take the Python
    paths, with identical results."""
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    want_bvh = build_bvh(scene, use_native=True)
    want_obj = obj_loader.load_obj(ASSET_OBJS[0], use_native=True)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))  # no g++
    assert not native.native_available()
    assert "g++" in native.build_error() or "No such file" in native.build_error()
    assert native.build_bvh_native(scene.vertices.numpy()) is None
    assert_bvh_equal(build_bvh(scene, use_native=True), want_bvh)
    assert_meshes_equal(obj_loader.load_obj(ASSET_OBJS[0], use_native=True), want_obj)

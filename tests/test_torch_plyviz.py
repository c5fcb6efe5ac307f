"""The port's PLY writers (utils/plyviz.py) against the JAX package's: for the
same scene and the same weight grid the files are byte-identical (the
analogue of tests/test_utils.py:119), and read_ply_counts reads the
committed artifacts/graphviz files."""

import os

import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.scene.dsl import load_params as j_load_params
from inverse_path_tracer_tpu.utils import plyviz as jply

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, build_scene, load_scene
from inverse_path_tracer_torch.scene.dsl import load_params
from inverse_path_tracer_torch.utils.plyviz import read_ply_counts, write_graph_ply, write_mesh_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
GRAPHVIZ = os.path.join(REPO, "artifacts", "graphviz")


def scene_pair(cornell_only: bool):
    if cornell_only:
        return (jipt.build_scene(j_load_params(SCENE0)[:1], asset_root=ASSET_ROOT),
                build_scene(load_params(SCENE0)[:1], asset_root=ASSET_ROOT))
    return (jipt.load_scene(SCENE0, asset_root=ASSET_ROOT),
            load_scene(SCENE0, asset_root=ASSET_ROOT))


def weights(n_tri: int, seed: int) -> np.ndarray:
    """An (nT+1, nT) grid with entries on both sides of p_min."""
    g = np.random.default_rng(seed)
    w = g.random((n_tri + 1, n_tri)).astype(np.float32) * 0.01
    w[g.random(w.shape) < 0.3] = 0.0
    return w


@pytest.mark.parametrize("cornell_only", [True, False])
def test_ply_files_match_the_jax_writer(tmp_path, cornell_only):
    js, ts = scene_pair(cornell_only)
    w = weights(ts.n_tri, seed=int(cornell_only))
    write_mesh_ply(ts, ts.diffuse, str(tmp_path / "mesh_t.ply"))
    jply.write_mesh_ply(js, js.diffuse, str(tmp_path / "mesh_j.ply"))
    n_t = write_graph_ply(ts, torch.from_numpy(w), str(tmp_path / "lines_t.ply"), p_min=2e-3)
    n_j = jply.write_graph_ply(js, w, str(tmp_path / "lines_j.ply"), p_min=2e-3)
    assert n_t == n_j == int((w[:ts.n_tri] > 2e-3).sum()) > 0
    for name in ("mesh", "lines"):
        got = (tmp_path / f"{name}_t.ply").read_bytes()
        assert got == (tmp_path / f"{name}_j.ply").read_bytes(), name
    mesh = read_ply_counts(str(tmp_path / "mesh_t.ply"))
    assert mesh["face"] == ts.n_tri
    if cornell_only:
        assert mesh["vertex"] == 12  # the reference artifact's count for the box
    assert read_ply_counts(str(tmp_path / "lines_t.ply")) == {"vertex": ts.n_tri, "edge": n_t}


def test_graph_with_no_edge(tmp_path):
    _, ts = scene_pair(False)
    path = str(tmp_path / "lines.ply")
    assert write_graph_ply(ts, np.zeros((31, 30), np.float32), path) == 0
    assert read_ply_counts(path) == {"vertex": 30, "edge": 0}


def test_read_ply_counts_on_the_artifacts():
    for name, want in (("mesh.ply", {"vertex": 20, "face": 30}),
                       ("lines.ply", {"vertex": 30, "edge": 642})):
        path = os.path.join(GRAPHVIZ, name)
        assert read_ply_counts(path) == want == jply.read_ply_counts(path)


def test_read_ply_counts_rejects_a_short_body(tmp_path):
    path = tmp_path / "bad.ply"
    text = open(os.path.join(GRAPHVIZ, "mesh.ply")).read().splitlines()
    path.write_text("\n".join(text[:-1]) + "\n")
    with pytest.raises(ValueError, match="body lines"):
        read_ply_counts(str(path))
    path.write_text("not a ply\n")
    with pytest.raises(ValueError, match="not an ASCII PLY"):
        read_ply_counts(str(path))

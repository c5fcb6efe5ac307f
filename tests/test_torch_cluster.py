"""The clustered sweep (kernel B10) and the kernels' triangle order, on the
CPU, against the JAX package.

  * cluster_k_for, kernel_perm and the packed tables (internal padded
    triangle count, plane rows, material table, emitter table with internal
    emitter indices, cluster boxes) equal JAX's _pack_tables exactly, on
    the generated 1298-triangle large scene at cluster_k 0 (auto) and 128
    and on scene 0 with CLUSTER_MIN_TP set to 8 in both packages and
    cluster_k=8.
  * The plain clustered sweep equals the dense sweep over the same
    (permuted) planes bit for bit, on random rays with zero direction
    components and origins inside cluster boxes.
"""

import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.ops.pallas import render_kernel as jrk
from inverse_path_tracer_tpu.scene.build import build_scene as jax_build_scene
from inverse_path_tracer_tpu.scene.dsl import ObjectParams as JaxObject

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, scene_from_numpy
from inverse_path_tracer_torch.assets import SPHERE_RINGS, SPHERE_SEGMENTS, large_scene
from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
from inverse_path_tracer_torch.ops.intersect import (
    counting_sweeps,
    intersect_clustered,
    intersect_planes,
    plane_rows,
)
from inverse_path_tracer_torch.ops.kernels import clusters
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    intersect_tile,
    intersect_tile_plain,
    pack_tables,
)
from test_torch_forward import SCENE0


def jax_large_scene(tmp_path, vertex_normals=True):
    """JAX's build of the port's large scene (the same generated sphere)."""
    obj = tmp_path / f"sphere_{int(vertex_normals)}.obj"
    obj.write_text(sphere_obj_text(SPHERE_RINGS, SPHERE_SEGMENTS, normals=vertex_normals))
    box = JaxObject(pos=(0, 0, 4), scl=(2, 2, 2), obj_file="CornellBox/CornellBox-Empty-CO.obj",
                    mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    ball = JaxObject(pos=(0, -1.5, 4), obj_file=str(obj), mtl_file="*Kd 0.5 0.5 0.5*")
    return jax_build_scene([box, ball], asset_root=ASSET_ROOT)


def to_port(js):
    return scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})


@pytest.fixture()
def small_clusters(monkeypatch):
    """Clusters on small scenes in both packages."""
    monkeypatch.setattr(jrk, "CLUSTER_MIN_TP", 8)
    monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 8)


def assert_tables_equal(js, ts, jcfg, tcfg):
    tp, pmat, table, etab, cdf, cab, ck = (np.asarray(x) if hasattr(x, "shape") else x
                                           for x in jrk._pack_tables(js, js.diffuse, jcfg))
    perm = jrk.kernel_perm(js, jcfg)
    tabs = pack_tables(ts, ts.diffuse, tcfg)
    nt = ts.n_tri
    assert tabs.cluster_k == ck == clusters.cluster_k_for(nt, tcfg) > 0
    assert tabs.padded_tri == tp
    np.testing.assert_array_equal(tabs.perm.numpy(), np.asarray(perm))
    # pmat rows j*tp + i hold plane j of internal triangle i.
    planes = pmat.reshape(4, tp, 4)[:, :nt].transpose(1, 0, 2).reshape(nt, 16)
    np.testing.assert_array_equal(tabs.planes.numpy(), planes)
    assert not pmat.reshape(4, tp, 4)[:, nt:].any()
    t = tabs.table.numpy()
    np.testing.assert_array_equal(t[:, 0:10], table[0:10, :nt].T)  # emission spec shin face_n
    np.testing.assert_array_equal(t[:, 10:13], (table[10:13] + table[-3:])[:, :nt].T)  # Kd
    np.testing.assert_array_equal(tabs.etab.numpy(), etab.T)  # internal emitter indices
    np.testing.assert_array_equal(tabs.cdf.numpy(), cdf[:, 0])
    np.testing.assert_array_equal(tabs.cab.numpy()[:, :6], cab[:6].T)
    if tabs.vtab is not None:
        np.testing.assert_array_equal(tabs.vtab.numpy()[:, :19], table[13:32, :nt].T)
    # The emitters are the same triangles in both orders.
    inv = np.argsort(tabs.perm.numpy())
    np.testing.assert_array_equal(tabs.etab[:, 15].numpy(), inv[ts.emissive_idx.numpy()])


@pytest.mark.parametrize("cluster_k,vertex_normals", [(0, True), (128, True), (0, False)])
def test_tables_match_jax_on_the_large_scene(tmp_path, cluster_k, vertex_normals):
    js = jax_large_scene(tmp_path, vertex_normals)
    ts = large_scene(vertex_normals=vertex_normals)
    assert ts.n_tri == 1298 and ts.has_vertex_normals == vertex_normals
    np.testing.assert_array_equal(ts.vertices.numpy(), np.asarray(js.vertices))
    jcfg = jipt.RenderConfig(cluster_k=cluster_k)
    tcfg = RenderConfig(cluster_k=cluster_k)
    assert clusters.cluster_k_for(ts.n_tri, tcfg) == (768 if cluster_k == 0 else 128)
    assert_tables_equal(js, ts, jcfg, tcfg)


def test_tables_match_jax_on_a_small_clustered_scene(small_clusters):
    js = jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    ts = to_port(js)
    assert_tables_equal(js, ts, jipt.RenderConfig(cluster_k=8), RenderConfig(cluster_k=8))
    perm = clusters.kernel_perm(ts, RenderConfig(cluster_k=8))
    assert not torch.equal(perm, torch.arange(ts.n_tri))  # a real permutation
    assert clusters.cluster_k_for(ts.n_tri, RenderConfig(cluster_k=5)) == 8  # rounded up


def test_cluster_policy():
    cfg = RenderConfig()
    assert clusters.cluster_k_for(30, cfg) == 0 and clusters.cluster_k_for(504, cfg) == 0
    assert clusters.cluster_k_for(505, cfg) == 256  # pads to 512
    assert clusters.cluster_k_for(1298, cfg) == 768
    assert clusters.cluster_k_for(4000, cfg) == 1024
    assert clusters.kernel_perm(large_scene(), cfg.with_(tri_order="file")) is None
    with pytest.raises(ValueError, match="tri_order"):
        RenderConfig(tri_order="z")
    with pytest.raises(ValueError, match="cluster_k"):
        RenderConfig(cluster_k=-8)
    d = torch.randn(5, 2)
    torch.testing.assert_close(clusters.unperm_rows(d[torch.tensor([3, 0, 4, 1, 2])],
                                                    torch.tensor([3, 0, 4, 1, 2])), d)


def random_rays(view, n, seed):
    """Rays from points inside cluster boxes and inside the scene's box,
    with some direction components exactly zero (either sign) and some
    rays axis-aligned."""
    g = np.random.default_rng(seed)
    cab = view.cab.numpy()
    c = g.integers(0, cab.shape[0], n)
    o = cab[c, 0:3] + g.random((n, 3)) * (cab[c, 3:6] - cab[c, 0:3])
    d = g.normal(size=(n, 3))
    d[g.random((n, 3)) < 0.2] = 0.0
    d[: n // 8] = np.eye(3)[g.integers(0, 3, n // 8)] * g.choice([-1.0, 1.0], (n // 8, 1))
    d[n // 8 : n // 4, 1] = -0.0
    d[np.abs(d).sum(1) == 0] = (0.0, -1.0, 0.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


@pytest.mark.parametrize("vertex_normals,cluster_k", [(False, 0), (True, 0), (False, 32)])
def test_clustered_sweep_equals_dense(vertex_normals, cluster_k):
    scene = large_scene(vertex_normals=vertex_normals)
    cfg = RenderConfig(cluster_k=cluster_k)
    view = clusters.kernel_view(scene, cfg)
    planes = plane_rows(view.scene)
    p, d = random_rays(view, 3000, seed=cluster_k + vertex_normals)
    with counting_sweeps() as counts:
        got = intersect_clustered(planes, view.cab, view.cluster_k, p, d, cfg.min_dot,
                                  cfg.epsilon)
    want = intersect_planes(planes, p, d, cfg.min_dot, cfg.epsilon)
    assert torch.equal(got.t, want.t) and torch.equal(got.tri, want.tri)
    assert torch.equal(got.point, want.point) and torch.equal(got.hit, want.hit)
    assert 0.3 < float(want.hit.float().mean()) < 1.0
    # Some clusters were skipped, and fewer pairs swept than the dense sweep.
    assert 0 < counts["entered"] < counts["tests"]
    assert counts["pairs"] < p.shape[0] * scene.n_tri
    # B10's wrapper on CPU tensors is its plain version and launches nothing.
    before = intersect_tile.launches
    t, idx = intersect_tile(scene, cfg, p.T.contiguous(), d.T.contiguous())
    assert intersect_tile.launches == before
    assert torch.equal(t, want.t) and torch.equal(idx, want.tri.to(torch.int32))
    t2, _ = intersect_tile_plain(scene, cfg, p.T.contiguous(), d.T.contiguous())
    assert torch.equal(t2, t)


def test_permuted_view_is_the_same_scene():
    scene = large_scene(vertex_normals=True)
    view = clusters.kernel_view(scene, RenderConfig())
    perm = view.perm
    assert torch.equal(view.scene.vertices, scene.vertices[perm])
    assert torch.equal(perm[view.scene.emissive_idx], scene.emissive_idx)
    assert torch.equal(view.scene.emissive_cdf, scene.emissive_cdf)
    torch.testing.assert_close(plane_rows(view.scene), plane_rows(scene)[perm], rtol=0, atol=0)
    # Every triangle lies inside its cluster's box.
    ck = view.cluster_k
    for c in range(view.cab.shape[0]):
        v = view.scene.vertices[c * ck : (c + 1) * ck].reshape(-1, 3)
        assert bool((v >= view.cab[c, 0:3]).all() and (v <= view.cab[c, 3:6]).all())

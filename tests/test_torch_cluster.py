"""The clustered sweep (kernel B10) and the kernels' triangle order, on the
CPU, against the JAX package.

  * cluster_k_for, kernel_perm and the packed tables (internal padded
    triangle count, plane rows, material table, emitter table with internal
    emitter indices, cluster boxes) equal JAX's _pack_tables exactly, on
    the generated 1298-triangle large scene at cluster_k 768 (JAX's auto
    width) and 128 and on scene 0 with CLUSTER_MIN_TP set to 8 in both
    packages and cluster_k=8.
  * The plain clustered sweep, two-level (group boxes, then cluster
    boxes), equals the dense sweep over the same (permuted) planes bit for
    bit, on random rays with zero direction components and origins inside
    cluster boxes, at several widths and group sizes; every group box
    contains its clusters' boxes; group_boxes equals a direct computation.
  * A float32 mirror of the kernels' divide-free pre-test
    (render_common.cuh sweep) never rejects a pair that the exact test
    accepts, on adversarial values next to eps, t_best and min_dot; the
    kernels' wrappers refuse epsilon and min_dot outside its range.
"""

import os
import re

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
from inverse_path_tracer_torch.ops.kernels import clusters, render_kernel
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


@pytest.mark.parametrize("cluster_k,vertex_normals", [(768, True), (128, True), (768, False)])
def test_tables_match_jax_on_the_large_scene(tmp_path, cluster_k, vertex_normals):
    js = jax_large_scene(tmp_path, vertex_normals)
    ts = large_scene(vertex_normals=vertex_normals)
    assert ts.n_tri == 1298 and ts.has_vertex_normals == vertex_normals
    np.testing.assert_array_equal(ts.vertices.numpy(), np.asarray(js.vertices))
    if cluster_k == 768:  # JAX's auto width on this scene
        assert jrk.cluster_k_for(ts.n_tri, jipt.RenderConfig()) == 768
    jcfg = jipt.RenderConfig(cluster_k=cluster_k)
    tcfg = RenderConfig(cluster_k=cluster_k)
    assert clusters.cluster_k_for(ts.n_tri, tcfg) == cluster_k
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
    assert clusters.cluster_k_for(30, cfg) == 0 and clusters.cluster_k_for(120, cfg) == 0
    # The auto width of this card on every clustered scene (pads to 128 and up).
    for n_tri in (121, 242, 505, 1298, 4000):
        assert clusters.cluster_k_for(n_tri, cfg) == clusters.CLUSTER_AUTO_K == 16
    assert clusters.cluster_k_for(1298, cfg.with_(cluster_k=768)) == 768
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


@pytest.mark.parametrize("vertex_normals,cluster_k", [(False, 0), (True, 0), (False, 768)])
def test_clustered_sweep_equals_dense(vertex_normals, cluster_k):
    scene = large_scene(vertex_normals=vertex_normals)
    cfg = RenderConfig(cluster_k=cluster_k)
    view = clusters.kernel_view(scene, cfg)
    planes = plane_rows(view.scene)
    p, d = random_rays(view, 3000, seed=cluster_k + vertex_normals)
    with counting_sweeps() as counts:
        got = intersect_clustered(planes, view.cab, view.gab, view.cluster_k, view.group, p, d,
                                  cfg.min_dot, cfg.epsilon)
    want = intersect_planes(planes, p, d, cfg.min_dot, cfg.epsilon)
    assert torch.equal(got.t, want.t) and torch.equal(got.tri, want.tri)
    assert torch.equal(got.point, want.point) and torch.equal(got.hit, want.hit)
    assert 0.3 < float(want.hit.float().mean()) < 1.0
    # Some groups and clusters were skipped, and fewer pairs swept than the
    # dense sweep.
    assert 0 < counts["group_entered"] < counts["group_tests"]
    assert 0 < counts["entered"] <= counts["tests"]
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


@pytest.mark.parametrize("vertex_normals,cluster_k,group", [
    (False, 16, 8), (True, 32, 8), (False, 32, 3), (True, 64, 1), (False, 128, 2),
    (True, 16, 64)])
def test_two_level_sweep_equals_dense(vertex_normals, cluster_k, group):
    scene = large_scene(vertex_normals=vertex_normals)
    view = clusters.kernel_view(scene, RenderConfig(cluster_k=cluster_k))
    cab = view.cab
    gab = clusters.group_boxes(cab, group)
    n_clusters = cab.shape[0]
    assert gab.shape == (-(-(n_clusters - 1) // group), 8)
    for g in range(gab.shape[0]):  # each group box holds its clusters' boxes
        member = cab[1 + g * group : 1 + (g + 1) * group]
        assert bool((gab[g, 0:3] <= member[:, 0:3]).all() and (gab[g, 3:6] >= member[:, 3:6]).all())
    planes = plane_rows(view.scene)
    p, d = random_rays(view, 2000, seed=cluster_k + group)
    with counting_sweeps() as counts:
        got = intersect_clustered(planes, cab, gab, cluster_k, group, p, d)
    want = intersect_planes(planes, p, d)
    assert torch.equal(got.t, want.t) and torch.equal(got.tri, want.tri)
    assert torch.equal(got.point, want.point) and torch.equal(got.hit, want.hit)
    assert counts["group_tests"] == p.shape[0] * gab.shape[0]
    assert 0 < counts["group_entered"] <= counts["group_tests"]
    assert counts["pairs"] < p.shape[0] * scene.n_tri


@pytest.mark.parametrize("group", [1, 3, 8])
def test_group_boxes_match_a_direct_computation(group):
    g = np.random.default_rng(group)
    lo = g.normal(size=(11, 3)).astype(np.float32)
    hi = lo + g.random((11, 3)).astype(np.float32)
    cab = torch.from_numpy(np.concatenate([lo, hi, np.zeros((11, 2), np.float32)], axis=1))
    got = clusters.group_boxes(cab, group).numpy()
    want = []
    for first in range(1, 11, group):  # cluster 0 is in no group
        rows = slice(first, min(first + group, 11))
        want.append(np.concatenate([lo[rows].min(0), hi[rows].max(0), np.zeros(2, np.float32)]))
    np.testing.assert_array_equal(got, np.stack(want))


def pretest_constants():
    """The relative margins of render_common.cuh's divide-free pre-test."""
    path = os.path.join(os.path.dirname(clusters.__file__), "render_common.cuh")
    src = open(path).read()
    return [np.float32(re.search(rf"{name} = ([0-9.e+-]+)f;", src).group(1))
            for name in ("kPretestLo", "kPretestHi")]


def pretest(a0, b0, t_best, min_dot, eps):
    """A float32 mirror of the kernels' pre-test (render_common.cuh sweep):
    with s = |b0| and a = a0 signed so that the exact t = a0 / -b0 is a / s,
    keep a pair only where s >= min_dot, a >= (eps * lo) * s and a <=
    (t_best * s) * hi; products only, each rounded once."""
    lo, hi = (torch.tensor(c) for c in pretest_constants())
    s = b0.abs()
    a = torch.where(b0 < 0, a0, -a0)
    return (s >= min_dot) & (a >= (eps * lo) * s) & (a <= (t_best * s) * hi)


def exact_test(a0, b0, t_best, min_dot, eps):
    t = a0 / (-b0)
    return (b0.abs() >= min_dot) & (t >= eps) & (t < t_best)


CASES = ["near_eps", "near_t_best", "near_min_dot", "random", "smallest_eps"]


@pytest.mark.parametrize("case", CASES)
def test_pretest_never_rejects_an_accepted_pair(case):
    g = np.random.default_rng(CASES.index(case))
    n = 400_000
    f32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    # smallest_eps: eps * min_dot at the least value the kernels accept.
    eps = f32(2e-26 if case == "smallest_eps" else 1e-2)
    min_dot = f32(1e-4)
    b0 = f32(g.choice([-1.0, 1.0], n) * 10.0 ** g.uniform(-4.5, 1, n))
    t_best = f32(10.0 ** g.uniform(-2.5, 3, n))
    t_best[: n // 50] = float("inf")
    if case in ("near_eps", "smallest_eps"):
        target = eps.expand(n)
    elif case == "near_t_best":
        target = torch.where(torch.isinf(t_best), f32(1e3).expand(n), t_best)
    else:
        target = f32(10.0 ** g.uniform(-3, 3, n))
    if case == "near_min_dot":
        b0 = f32(g.choice([-1.0, 1.0], n)) * min_dot * f32(1 + g.integers(-4, 5, n) * 2.0 ** -23)
    # a0 such that t = a0 / -b0 lands on and a few ulps around the target.
    a0 = target * (-b0)
    steps = f32(g.integers(-6, 7, n)).to(torch.int32)
    a0 = f32(np.asarray(a0.numpy().view(np.int32) + steps.numpy(), np.int32).view(np.float32))
    accepted = exact_test(a0, b0, t_best, min_dot, eps)
    kept = pretest(a0, b0, t_best, min_dot, eps)
    assert int(accepted.sum()) > n // 20
    assert not bool((accepted & ~kept).any())
    # The pre-test is a real filter: most rejected pairs are rejected by it.
    if case == "random":
        assert int((~kept).sum()) > int((~accepted).sum()) // 2


@pytest.mark.parametrize("epsilon,min_dot", [(0.0, 1e-4), (-1e-2, 1e-4), (1e-2, 0.0),
                                             (1e-28, 1e-4)])
def test_kernels_refuse_values_outside_the_pretest_range(epsilon, min_dot):
    """The kernels' wrappers refuse epsilon and min_dot outside the range
    where the pre-test is exact (render_kernel.py _trace_params)."""
    scene = large_scene(vertex_normals=False)
    cfg = RenderConfig(epsilon=epsilon, min_dot=min_dot)
    p = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="epsilon > 0, min_dot > 0"):
        render_kernel._trace_params(scene.diffuse, scene, cfg, None, p, p)
    params, _ = render_kernel._trace_params(scene.diffuse, scene, RenderConfig(), None, p, p)
    assert params.cluster_k == clusters.CLUSTER_AUTO_K and params.n_groups > 0

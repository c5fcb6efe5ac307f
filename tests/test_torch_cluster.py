"""The clustered sweep (kernel B10) and the kernels' triangle order, on the
CPU, against the JAX package.

  * cluster_k_for, kernel_perm and the packed tables (internal padded
    triangle count, plane rows, material table, emitter table with internal
    emitter indices, cluster boxes) equal JAX's _pack_tables exactly, on
    the generated 1298-triangle large scene at cluster_k 768 (JAX's auto
    width) and 128 and on scene 0 with CLUSTER_MIN_TP set to 8 in both
    packages and cluster_k=8; morton_order equals JAX's _morton_order on a
    crafted vertex set (tests/morton_cases.py).
  * The plain clustered sweep, two-level (group boxes, then cluster
    boxes), equals the dense sweep over the same (permuted) planes bit for
    bit, on random rays with zero direction components and origins inside
    cluster boxes, at several widths and group sizes; every group box
    contains its clusters' boxes; group_boxes equals a direct computation.
  * A float32 mirror of the kernels' divide-free pre-test
    (render_common.cuh sweep) never rejects a pair that the exact test
    accepts, on adversarial values next to eps, t_best and min_dot, and at
    t_best itself (the cooperative sweep's ties); the kernels' wrappers
    refuse epsilon and min_dot outside its range.
  * A Python mirror of B10's warp-cooperative schedule (render_common.cuh
    cluster_hit: the bit helpers, the hand-out, the queue, the merge)
    equals the dense sweep on full warps, on warps with lanes masked off
    and on warps whose lanes without a ray take part; its box tests and
    pairs equal counting_sweeps'; exact ties (assets.doubled_scene) keep
    the lowest internal index; counting_sweeps' loop_slots (the per-lane
    loop's lane-slots) match a direct computation.
"""

import os
import re
from types import SimpleNamespace
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.ops.pallas import render_kernel as jrk
from inverse_path_tracer_tpu.scene.build import build_scene as jax_build_scene
from inverse_path_tracer_tpu.scene.dsl import ObjectParams as JaxObject

import torch_threads  # noqa: F401
from morton_cases import crafted_vertices, reference_order

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, scene_from_numpy
from inverse_path_tracer_torch.assets import SPHERE_RINGS, SPHERE_SEGMENTS, large_scene
from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
from inverse_path_tracer_torch.ops.intersect import (
    _t_masked,
    counting_sweeps,
    intersect_clustered,
    intersect_planes,
    inv_dir,
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


@pytest.mark.parametrize("hot", [0, 16])
def test_morton_order_matches_jax_on_crafted_vertices(hot):
    """morton_order on crafted vertices (tests/morton_cases.py: ties, a zero
    extent, vertex sums whose / 3 and * float32(1/3) fall in different
    cells) returns its order on the vertices' device, equal to JAX's
    _morton_order and to the numpy reference; the sum / 3 would not be."""
    v = crafted_vertices()
    order = clusters.morton_order(torch.from_numpy(v), hot)
    assert order.device.type == "cpu" and order.dtype == torch.int64
    want = np.asarray(jrk._morton_order(SimpleNamespace(vertices=jnp.asarray(v)), hot))
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(reference_order(v, hot), want)
    assert not np.array_equal(reference_order(v, hot, divide=True), want)


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


def exact_test(a0, b0, t_best, min_dot, eps, ties=False):
    """The exact test; `ties` (sweep<true>) also accepts t == t_best."""
    t = a0 / (-b0)
    return (b0.abs() >= min_dot) & (t >= eps) & ((t <= t_best) if ties else (t < t_best))


CASES = ["near_eps", "near_t_best", "near_min_dot", "random", "smallest_eps", "ties_at_t_best"]


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
    elif case in ("near_t_best", "ties_at_t_best"):
        target = torch.where(torch.isinf(t_best), f32(1e3).expand(n), t_best)
    else:
        target = f32(10.0 ** g.uniform(-3, 3, n))
    if case == "near_min_dot":
        b0 = f32(g.choice([-1.0, 1.0], n)) * min_dot * f32(1 + g.integers(-4, 5, n) * 2.0 ** -23)
    # a0 such that t = a0 / -b0 lands on and a few ulps around the target.
    a0 = target * (-b0)
    steps = f32(g.integers(-6, 7, n)).to(torch.int32)
    a0 = f32(np.asarray(a0.numpy().view(np.int32) + steps.numpy(), np.int32).view(np.float32))
    if case == "ties_at_t_best":  # every t a kept hit can tie with
        t_best = torch.where(torch.isinf(t_best), t_best, a0 / (-b0))
    accepted = exact_test(a0, b0, t_best, min_dot, eps, ties=case == "ties_at_t_best")
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


# --- B10's warp-cooperative schedule: a Python mirror ----------------------
#
# Transcribed from render_common.cuh (nth_bit, drop_bits, items_before,
# item_holder, cluster_hit), one warp at a time over a set of active lanes.
# The mirror holds the schedule's design on the CPU (hand-out, holder
# lookup, merge, counts); the card tests (tests/test_torch_cuda.py) hold the
# CUDA code itself.

def popc(m):
    return bin(m).count("1")


def nth_bit(m, k):
    pos = 0
    for w in (16, 8, 4, 2, 1):
        c = popc(m & ((1 << w) - 1))
        if k >= c:
            k -= c
            m >>= w
            pos += w
    return pos


def drop_bits(m, k):
    if k <= 0:
        return m
    if k >= popc(m):
        return 0
    return m & ~((1 << nth_bit(m, k)) - 1)


def items_before(lanes, count):
    """Each lane's exclusive prefix of `count`, one ballot per bit."""
    pre = {lane: 0 for lane in lanes}
    for b in range(6):
        ballot = sum(1 << lane for lane in lanes if (count[lane] >> b) & 1)
        for lane in lanes:
            pre[lane] += popc(ballot & ((1 << lane) - 1)) << b
    return pre


def item_holder(lanes, count, pre, want, s):
    """{lane: (holder lane, rank among its items)} of item s[lane]."""
    starts = 0
    for lane in lanes:
        if count[lane] > 0 and pre[lane] < 32:
            starts |= 1 << pre[lane]
    holders = sum(1 << lane for lane in lanes if count[lane] > 0)
    out = {}
    for lane in lanes:
        if not want[lane]:
            out[lane] = (lane, 0)
            continue
        upto = starts & ((2 << s[lane]) - 1) & 0xFFFFFFFF
        out[lane] = (nth_bit(holders, popc(upto) - 1), s[lane] - (upto.bit_length() - 1))
    return out


class SweepData(NamedTuple):
    """What the mirror reads of each ray: the exact t of every triangle
    (inf where the exact test rejects; intersect.py _t_masked) and the slab
    interval of every group and cluster box (intersect.py enters_box)."""

    t: torch.Tensor  # (R, nT)
    g_lo: torch.Tensor  # (R, G) t_min, t_max of the group boxes
    g_hi: torch.Tensor
    c_lo: torch.Tensor  # (R, C) the same of the cluster boxes
    c_hi: torch.Tensor


def slabs(boxes, p, inv_d):
    t1 = (boxes[None, :, 0:3] - p[:, None]) * inv_d[:, None]
    t2 = (boxes[None, :, 3:6] - p[:, None]) * inv_d[:, None]
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    t_min = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    t_max = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    return t_min, t_max


def sweep_data(planes, cab, gab, p, d, cfg):
    inv_d = inv_dir(d)
    t = _t_masked(planes, p, d, cfg.min_dot, cfg.epsilon)
    return SweepData(t, *slabs(gab, p, inv_d), *slabs(cab, p, inv_d))


def mirror_warp(data, rays, cluster_k, group, n_tri, lanes=None):
    """cluster_hit for the rays {lane: ray} of the calling lanes `lanes`
    (default: those lanes alone; a calling lane without a ray has `active`
    false): ({lane: (t, idx)} of the rays, the warp's (group tests, cluster
    tests, pairs, slots))."""
    lanes = sorted(rays if lanes is None else lanes)
    width = len(lanes)
    rank = {lane: i for i, lane in enumerate(lanes)}
    n_groups, n_clusters = data.g_lo.shape[1], data.c_lo.shape[1]
    t = {lane: data.t[r] for lane, r in rays.items()}

    def enters(lo, hi, r, j, t_cull):
        return bool(hi[r, j] >= max(float(lo[r, j]), 0.0)) and bool(lo[r, j] <= t_cull)

    def sweep(lane, lo, rows, t_best, best):
        """sweep<true>: the least (t, index) of the rows and (t_best, best)."""
        row = t[lane][lo:lo + rows]
        k = int(torch.argmin(row))
        tk = float(row[k])
        return min((t_best, best), (tk, lo + k)) if tk <= t_best else (t_best, best)

    rows0 = min(cluster_k, n_tri)
    best = {lane: sweep(lane, 0, rows0, float("inf"), 0) for lane in rays}
    work = [0, 0, len(rays) * rows0, 32 * rows0]
    last = n_clusters - 1
    tail_rows = n_tri - last * cluster_k
    tail_group = (last - 1) // group if tail_rows < cluster_k and last > 0 else -1
    for g0 in range(0, n_groups, 32):
        t_cull = {lane: best[lane][0] for lane in rays}
        gn = min(32, n_groups - g0)
        gm = {lane: sum(1 << j for j in range(gn) if lane in rays and
                        enters(data.g_lo, data.g_hi, rays[lane], g0 + j, t_cull[lane]))
              for lane in lanes}
        work[0] += len(rays) * gn
        tail = {lane: g0 <= tail_group < g0 + gn and bool((gm[lane] >> (tail_group - g0)) & 1)
                for lane in rays}
        queue = []  # (cluster, owner lane)
        while True:
            g_items = sum(popc(m) for m in gm.values())
            if len(queue) >= width or (g_items == 0 and queue):
                merged = dict(best)
                for lane in lanes:
                    if rank[lane] < len(queue):
                        c, owner = queue[len(queue) - 1 - rank[lane]]
                        merged[owner] = min(merged[owner],
                                            sweep(owner, c * cluster_k, cluster_k, *best[owner]))
                        work[2] += cluster_k
                work[3] += 32 * cluster_k
                best = merged
                del queue[max(len(queue) - width, 0):]
            elif g_items > 0:
                count = {lane: popc(gm[lane]) for lane in lanes}
                pre = items_before(lanes, count)
                take = {lane: rank[lane] < g_items for lane in lanes}
                src = item_holder(lanes, count, pre, take, rank)
                pushed = []
                for lane in lanes:
                    if take[lane]:
                        owner, r = src[lane]
                        g = g0 + nth_bit(gm[owner], r)
                        c_lo = 1 + g * group
                        c_hi = min(c_lo + group, last if g == tail_group else n_clusters)
                        pushed += [(c, owner) for c in range(c_lo, c_hi)
                                   if enters(data.c_lo, data.c_hi, rays[owner], c, t_cull[owner])]
                        work[1] += c_hi - c_lo
                queue += pushed
                gm = {lane: drop_bits(gm[lane], width - pre[lane]) for lane in lanes}
            else:
                break
        if g0 <= tail_group < g0 + gn:
            swept = False
            for lane in rays:
                work[1] += tail[lane]
                if tail[lane] and enters(data.c_lo, data.c_hi, rays[lane], last, t_cull[lane]):
                    best[lane] = sweep(lane, last * cluster_k, tail_rows, *best[lane])
                    work[2] += tail_rows
                    swept = True
            work[3] += 32 * tail_rows * swept
    return best, work


def mirror_sweep(view, cfg, p, d, alive, whole_warp=False):
    """The mirror over warps of 32 consecutive rays, lanes where `alive`
    calling, or with whole_warp every lane (the dead ones without a ray):
    (t, idx) of every ray (inf, 0 where dead) and the summed work."""
    planes = plane_rows(view.scene)
    data = sweep_data(planes, view.cab, view.gab, p, d, cfg)
    n = p.shape[0]
    t = torch.full((n,), float("inf"))
    idx = torch.zeros(n, dtype=torch.int64)
    work = [0, 0, 0, 0]
    for w0 in range(0, n, 32):
        rays = {r - w0: r for r in range(w0, min(w0 + 32, n)) if alive[r]}
        if not rays:
            continue
        best, wk = mirror_warp(data, rays, view.cluster_k, view.group, planes.shape[0],
                               range(min(32, n - w0)) if whole_warp else None)
        for lane, (tb, ib) in best.items():
            t[rays[lane]], idx[rays[lane]] = tb, ib
        work = [a + b for a, b in zip(work, wk)]
    return t, idx, work


def test_bit_helpers_match_a_direct_computation():
    g = np.random.default_rng(3)
    for m in [int(x) for x in g.integers(1, 1 << 32, 300)] + [1, 1 << 31, 0xFFFFFFFF]:
        bits = [i for i in range(32) if (m >> i) & 1]
        for k in range(len(bits)):
            assert nth_bit(m, k) == bits[k]
            assert drop_bits(m, k) == sum(1 << b for b in bits[k:])
        assert drop_bits(m, len(bits)) == 0 and drop_bits(m, 0) == m
    lanes = [0, 3, 4, 9, 17, 31]
    count = {0: 2, 3: 0, 4: 5, 9: 1, 17: 33, 31: 7}
    pre = items_before(lanes, count)
    assert [pre[lane] for lane in lanes] == [0, 2, 2, 7, 8, 41]
    s = {lane: i for i, lane in enumerate(lanes)}
    got = item_holder(lanes, count, pre, {lane: True for lane in lanes}, s)
    assert [got[lane] for lane in lanes] == [(0, 0), (0, 1), (4, 0), (4, 1), (4, 2), (4, 3)]


def per_lane_work(data, cluster_k, group, n_tri, cull=True):
    """The work of a per-lane loop on the rays of `data`, directly: each ray
    sweeps cluster 0, tests the cluster boxes of each group whose box it
    enters and sweeps each cluster whose box it enters, no later than its
    closest hit so far (cull) or than its hit in cluster 0 alone (the most
    that any order of the same boxes tests and sweeps).  Returns the
    (ray, cluster) box tests and the clusters (R, C) bool that each ray
    sweeps."""
    n_c = data.c_lo.shape[1]
    t_c = torch.stack([data.t[:, c * cluster_k:min((c + 1) * cluster_k, n_tri)].min(1).values
                       for c in range(n_c)], 1)
    t0 = t_c[:, 0].clone()
    t = t0.clone()
    swept = torch.zeros(t_c.shape, dtype=torch.bool)
    swept[:, 0] = True
    tests = 0

    def enters(lo, hi, t_best):
        return (hi >= lo.clamp(min=0.0)) & (lo <= t_best)

    for g in range(data.g_lo.shape[1]):
        in_g = enters(data.g_lo[:, g], data.g_hi[:, g], t if cull else t0)
        for c in range(1 + g * group, min(1 + (g + 1) * group, n_c)):
            tests += int(in_g.sum())
            swept[:, c] = in_g & enters(data.c_lo[:, c], data.c_hi[:, c], t if cull else t0)
            t = torch.where(swept[:, c], torch.minimum(t, t_c[:, c]), t)
    return tests, swept


def secondary_rays(view, cfg, n, seed):
    """The rays of a bounce: from the hits of random_rays, about the face
    normal that faces the incoming ray, cosine-weighted (the incoherent
    rays that the sweep meets after the camera rays)."""
    p, d = random_rays(view, n, seed)
    hit = intersect_planes(plane_rows(view.scene), p, d, cfg.min_dot, cfg.epsilon)
    n_f = view.scene.face_normal[hit.tri]
    n_f = torch.where(((n_f * d).sum(1) > 0)[:, None], -n_f, n_f)
    g = torch.Generator().manual_seed(seed)
    r = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    keep = hit.hit
    return hit.point[keep], torch.nn.functional.normalize(n_f + r, dim=1)[keep]


def camera_like_rays(n, seed):
    """Rays from the camera's origin into the box, jittered about the view
    axis: coherent neighbours, as B7's primary rays."""
    g = torch.Generator().manual_seed(seed)
    xy = (torch.arange(n) % 32).float()[:, None] / 32.0 + torch.rand((n, 2), generator=g) / 32.0
    d = torch.cat([xy * 1.2 - 0.6, torch.ones((n, 1))], dim=1)
    return torch.zeros((n, 3)), torch.nn.functional.normalize(d, dim=1)


def make_rays(kind, view, cfg, n, seed):
    if kind == "box":
        return random_rays(view, n, seed)
    if kind == "secondary":
        return secondary_rays(view, cfg, n, seed)
    return camera_like_rays(n, seed)


@pytest.mark.parametrize("kind,dead", [("box", None), ("secondary", None), ("camera", None),
                                       ("secondary", "masked"), ("camera", "masked"),
                                       ("secondary", "calling")])
def test_cooperative_schedule_equals_dense(kind, dead):
    """The mirror of B10's warp-cooperative schedule, on full warps and on
    warps with about a third of the lanes without a ray, either masked off
    (the sweep called from lane-divergent code) or calling with `active`
    false (intersect_lanes): every live ray's hit (t and internal index)
    equals the dense sweep's; its group box tests equal
    intersect_clustered's on the live rays, and its cluster box tests and
    pairs lie between the per-lane loop's (counting_sweeps) and those of a
    loop that culls against cluster 0's hit alone; its pair loop issues at
    least a slot a pair and, on full warps, no more slots than the per-lane
    loop (counting_sweeps' loop_slots)."""
    scene = large_scene(vertex_normals=False)
    cfg = RenderConfig()
    view = clusters.kernel_view(scene, cfg)
    planes = plane_rows(view.scene)
    p, d = make_rays(kind, view, cfg, 1536, seed=5)
    g = np.random.default_rng(6)
    alive = torch.from_numpy(g.random(p.shape[0]) >= (1 / 3 if dead else 0))
    t, idx, work = mirror_sweep(view, cfg, p, d, alive, whole_warp=dead == "calling")
    want = intersect_planes(planes, p[alive], d[alive], cfg.min_dot, cfg.epsilon)
    assert torch.equal(t[alive], want.t) and torch.equal(idx[alive], want.tri)
    assert 0.3 < float(want.hit.float().mean())
    with counting_sweeps() as c:
        intersect_clustered(planes, view.cab, view.gab, view.cluster_k, view.group, p[alive],
                            d[alive], cfg.min_dot, cfg.epsilon)
    data = sweep_data(planes, view.cab, view.gab, p[alive], d[alive], cfg)
    most_tests, most = per_lane_work(data, view.cluster_k, view.group, planes.shape[0], cull=False)
    rows = (planes.shape[0] - torch.arange(most.shape[1]) * view.cluster_k).clamp(
        max=view.cluster_k)
    assert work[0] == c["group_tests"]
    assert c["tests"] <= work[1] <= most_tests
    assert c["pairs"] <= work[2] <= int((most.long() * rows).sum())
    assert c["entered"] > 0 and work[2] <= work[3]
    if not dead:
        assert work[3] <= c["loop_slots"]


@pytest.mark.parametrize("tri_order", ["file", "morton"])
def test_exact_ties_keep_the_lowest_index(tri_order):
    """On a scene of every triangle twice (assets.doubled_scene), whose hits
    tie exactly with their copies', in clusters and groups apart in file
    order: intersect_clustered and the mirror of B10's schedule equal the
    dense sweep, internal index included; the hit is the lower of the two
    copies."""
    from inverse_path_tracer_torch.assets import doubled_scene

    base = large_scene(vertex_normals=False)
    scene = doubled_scene(base)
    cfg = RenderConfig(tri_order=tri_order)
    view = clusters.kernel_view(scene, cfg)
    assert view.cluster_k == 16
    planes = plane_rows(view.scene)
    p, d = random_rays(view, 1024, seed=8)
    want = intersect_planes(planes, p, d, cfg.min_dot, cfg.epsilon)
    got = intersect_clustered(planes, view.cab, view.gab, view.cluster_k, view.group, p, d,
                              cfg.min_dot, cfg.epsilon)
    assert torch.equal(got.t, want.t) and torch.equal(got.tri, want.tri)
    t, idx, _ = mirror_sweep(view, cfg, p, d, torch.ones(p.shape[0], dtype=torch.bool))
    assert torch.equal(t, want.t) and torch.equal(idx, want.tri)
    perm = torch.arange(scene.n_tri) if view.perm is None else view.perm
    inv = torch.argsort(perm)
    hit = want.tri[want.hit]
    copy = inv[(perm[hit] + base.n_tri) % scene.n_tri]  # the other copy's internal index
    assert bool((copy > hit).all())  # the lower index won the tie
    apart = (copy // 16) != (hit // 16)
    if tri_order == "file":
        assert bool(apart.all()) and bool(((copy - 1) // 128 != (hit - 1) // 128).any())


def test_loop_slots_match_a_direct_computation():
    """counting_sweeps' box tests, pairs and loop_slots on 64 hand-built
    rays (a warp of coherent camera rays, a warp of rays from inside the
    box) against a direct computation (per_lane_work): each ray sweeps
    cluster 0 and each cluster it enters, with its group, no later than its
    closest hit so far; a per-lane loop issues 32 slots for each row of
    each cluster that any ray of the warp sweeps."""
    scene = large_scene(vertex_normals=False)
    cfg = RenderConfig()
    view = clusters.kernel_view(scene, cfg)
    planes = plane_rows(view.scene)
    ck, grp = view.cluster_k, view.group
    p0, d0 = camera_like_rays(32, seed=1)
    p1, d1 = random_rays(view, 32, seed=2)
    p, d = torch.cat([p0, p1]), torch.cat([d0, d1])
    with counting_sweeps() as counts:
        intersect_clustered(planes, view.cab, view.gab, ck, grp, p, d, cfg.min_dot, cfg.epsilon)
    tests, swept = per_lane_work(sweep_data(planes, view.cab, view.gab, p, d, cfg), ck, grp,
                                 scene.n_tri)
    swept = swept.numpy()
    n_c, n_tri = swept.shape[1], scene.n_tri
    rows = [min(ck, n_tri - c * ck) for c in range(n_c)]
    pairs = int((swept * np.array(rows)).sum())
    slots = 32 * sum(rows[c] for w in (0, 32) for c in range(n_c) if swept[w:w + 32, c].any())
    assert (counts["tests"], counts["pairs"], counts["loop_slots"]) == (tests, pairs, slots)
    assert swept[:, 1:].sum() > 0 and slots > pairs

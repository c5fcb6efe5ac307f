"""The BVH render route (RenderConfig.intersect="bvh") on the CPU.

  * The port's plain route against the JAX package's render_range(backend=
    "xla", intersect="bvh") in external mode (JAX's camera rays and bounce
    uniforms), at 8x8/2 spp/4 bounces: on scene 0 radiance rtol 1e-5 and
    counts equal; on the 1298-triangle vertex-normal large scene at least
    97% of lanes within rtol 1e-4 / atol 1e-5 (the knife-edge bound of the
    other vertex-normal parity tests) and counts equal.
  * The gradient against jax.grad through the same JAX route (its default
    grad_mode "custom", the analytic per-tile VJP: AD cannot run through
    the traversal's while loop): rtol 1e-4 with an absolute floor of 1e-6
    of the largest entry on scene 0; the vertex-normal bound on the large
    scene.
  * The route equals the sweep route bit for bit: radiance, counts, the
    autograd gradient and loss_and_grad_range's (the hits are the same).
  * Gradients on the 3858-triangle scene (the box and a flat 3840-triangle
    sphere) through both routes against jax.grad of JAX's XLA path at
    4x4/1 spp/4 bounces, rtol 1e-4 with the same floor.
  * RenderConfig(intersect=...) validation, its conversion from a JAX
    config, the route's view and tables (leaf order, node rows, refused
    trees), and `render --intersect bvh` writing the image the sweep writes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.config import CameraConfig as JaxCamera
from inverse_path_tracer_tpu.ops import bvh as jbvh
from inverse_path_tracer_tpu.render import forward as jfwd
from inverse_path_tracer_tpu.scene.build import build_scene as jax_build_scene
from inverse_path_tracer_tpu.scene.dsl import ObjectParams as JaxObject

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import (
    ASSET_ROOT,
    RenderConfig,
    cli,
    large_scene,
    load_scene,
    loss_and_grad_range,
    render_samples,
)
from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
from inverse_path_tracer_torch.convert import (
    jax_scene_fields,
    render_config_from_jax,
    scene_from_numpy,
)
from inverse_path_tracer_torch.ops.bvh import (
    MAX_STACK,
    BVHData,
    attach_bvh,
    build_bvh,
    check_bvh,
    node_rows,
)
from inverse_path_tracer_torch.ops.kernels import clusters
from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
from inverse_path_tracer_torch.render import forward
from inverse_path_tracer_torch.utils.png import read_png
from test_torch_cluster import jax_large_scene
from test_torch_forward import SCENE0, jax_rays_and_uniforms

CPU = dict(device="cpu")
SHAPE = dict(width=8, height=8, spp=2, max_bounces=4)


def with_bvh(js):
    """A JAX scene with its BVH and the port's copy of both."""
    jb = jbvh.attach_bvh(js)
    return jb, scene_from_numpy(jax_scene_fields(jb))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("route")
    return {"scene0": with_bvh(jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)),
            "large": with_bvh(jax_large_scene(tmp, vertex_normals=True))}


def jax_and_port_inputs(js, key_seed, shape=SHAPE):
    jcfg = jipt.RenderConfig(tile_size=64, backend="xla", intersect="bvh", **shape)
    key = jax.random.PRNGKey(key_seed)
    p, d, u = jax_rays_and_uniforms(js, jcfg, key)
    tcfg = RenderConfig(tile_size=48, rng="external", intersect="bvh", **shape)  # 3 launches
    return jcfg, key, tcfg, dict(rays=(p, d), uniforms=u, **CPU)


def lanes_close(got, want):
    """The share of samples whose radiance agrees within rtol 1e-4 / atol
    1e-5."""
    return float(np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1).mean())


def assert_grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * float(np.abs(want).max()))


def assert_vn_grad_close(got, want):
    """The JAX tests' bound for a vertex-normal scene's gradient
    (tests/test_pallas.py:263-270)."""
    rows_off = int((~np.isclose(got, want, rtol=2e-4, atol=1e-7).all(axis=1)).sum())
    assert rows_off <= 6
    np.testing.assert_allclose(got.sum(0), want.sum(0), rtol=1e-3)
    assert np.abs(got - want).sum() <= 1e-2 * np.abs(want).sum() + 1e-6


@pytest.mark.parametrize("kind", ["scene0", "large"])
def test_plain_route_matches_jax_bvh_route(scenes, kind):
    js, ts = scenes[kind]
    jcfg, key, tcfg, kw = jax_and_port_inputs(js, 5)
    assert not jfwd._use_pallas(jcfg, js)
    want, want_st = jfwd.render_samples(js.diffuse, js, key, jcfg)
    got, got_st = render_samples(ts.diffuse, ts, 0, tcfg, **kw)
    want = np.asarray(want)
    if kind == "scene0":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        assert lanes_close(got.numpy(), want) >= 0.97
    assert int(got_st.segments) == int(want_st.segments)
    assert int(got_st.shadow_rays) == int(want_st.shadow_rays)
    assert float(np.abs(want).sum()) > 0


@pytest.mark.parametrize("kind", ["scene0", "large"])
def test_route_gradient_matches_jax_grad(scenes, kind):
    js, ts = scenes[kind]
    jcfg, key, tcfg, kw = jax_and_port_inputs(js, 9)
    assert jcfg.grad_mode == "custom"
    w = np.random.default_rng(3).random((jcfg.n_samples, 3)).astype(np.float32)

    def jloss(m):
        vals, _ = jfwd.render_samples(m, js, key, jcfg)
        return jnp.sum(vals * w)

    want = np.asarray(jax.grad(jloss)(js.diffuse))
    m = ts.diffuse.clone().requires_grad_()
    vals, _ = render_samples(m, ts, 0, tcfg, **kw)
    (vals * torch.from_numpy(w)).sum().backward()
    (assert_grad_close if kind == "scene0" else assert_vn_grad_close)(m.grad.numpy(), want)
    assert np.count_nonzero(want) > 10


@pytest.mark.parametrize("kind", ["scene0", "large"])
def test_route_equals_the_sweep_route_bit_for_bit(scenes, kind):
    """The traversal's hits are the sweep's, so radiance, counts and both
    gradients are too.  The route is mega, and so is the sweep route here:
    on the CPU the staged plain versions round a vertex-normal scene's
    shading differently on a few lanes (tests/test_torch_staged.py)."""
    _, ts = scenes[kind]
    cfg = RenderConfig(tile_size=48, wavefront="mega", **SHAPE)
    w = torch.from_numpy(np.random.default_rng(4).random((cfg.n_samples, 3)).astype(np.float32))
    out = []
    for c in (cfg, cfg.with_(intersect="bvh")):
        m = ts.diffuse.clone().requires_grad_()
        vals, st = render_samples(m, ts, 7, c, **CPU)
        (vals * w).sum().backward()
        loss, g_lg, _ = loss_and_grad_range(ts.diffuse, ts, 7, c, 0, c.n_samples,
                                            lambda v, lo: (v * w[lo:lo + v.shape[0]]).sum(),
                                            **CPU)
        out.append((vals.detach(), int(st.segments), int(st.shadow_rays), m.grad, loss, g_lg))
    for a, b in zip(*out):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert float(out[0][3].abs().sum()) > 0


def over_budget_scenes(tmp_path):
    """The box and a flat lat-long sphere of 3840 triangles (3858 in all),
    in both packages, the port's with a BVH."""
    obj = tmp_path / "sphere_3840.obj"
    obj.write_text(sphere_obj_text(rings=16, segments=128, normals=False))
    box = JaxObject(pos=(0, 0, 4), scl=(2, 2, 2), obj_file="CornellBox/CornellBox-Empty-CO.obj",
                    mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    ball = JaxObject(pos=(0, -1.5, 4), obj_file=str(obj), mtl_file="*Kd 0.5 0.5 0.5*")
    js = jax_build_scene([box, ball], asset_root=ASSET_ROOT)
    return js, attach_bvh(scene_from_numpy(jax_scene_fields(js)))


def test_gradients_past_2048_triangles_match_jax_xla(tmp_path):
    js, ts = over_budget_scenes(tmp_path)
    assert ts.n_tri == 3858
    shape = dict(width=4, height=4, spp=1, max_bounces=4)
    jcfg = jipt.RenderConfig(tile_size=16, backend="xla", grad_mode="ad", **shape)
    key = jax.random.PRNGKey(2)
    w = np.random.default_rng(5).random((jcfg.n_samples, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda m: jnp.sum(jfwd.render_samples(m, js, key, jcfg)[0] * w))(
        js.diffuse))
    p, d, u = jax_rays_and_uniforms(js, jcfg, key)
    for intersect in ("auto", "bvh"):
        tcfg = RenderConfig(rng="external", intersect=intersect, **shape)
        m = ts.diffuse.clone().requires_grad_()
        vals, _ = render_samples(m, ts, 0, tcfg, rays=(p, d), uniforms=u, **CPU)
        (vals * torch.from_numpy(w)).sum().backward()
        assert_grad_close(m.grad.numpy(), want)
    assert np.count_nonzero(want) > 10


def test_intersect_config_and_its_conversion():
    assert RenderConfig().intersect == "auto"
    for v in ("auto", "brute", "bvh"):
        assert RenderConfig(intersect=v).intersect == v
    with pytest.raises(ValueError, match="intersect"):
        RenderConfig(intersect="kd")
    jcfg = jipt.RenderConfig(width=7, height=5, spp=3, max_bounces=9, intersect="bvh",
                             wavefront="mega", cluster_k=64, backend="xla", tile_size=512,
                             reference_quirks=False,
                             camera=JaxCamera(eye=(0.0, 1.0, 0.0), height_angle_deg=60.0))
    got = render_config_from_jax(jcfg)
    assert (got.width, got.height, got.spp, got.max_bounces) == (7, 5, 3, 9)
    assert (got.intersect, got.wavefront, got.cluster_k, got.reference_quirks) == (
        "bvh", "mega", 64, False)
    assert (got.backend, got.tile_size) == ("auto", RenderConfig().tile_size)
    assert got.camera.eye == (0.0, 1.0, 0.0) and got.camera.height_angle_deg == 60.0


def test_the_route_view_and_tables(scenes):
    """The route's internal order is the BVH's leaf order; its tables carry
    the node rows and each row's global index; only scenes with a BVH under
    intersect="bvh" take it, and it is never staged."""
    _, ts = scenes["large"]
    cfg = RenderConfig(intersect="bvh")
    view = clusters.kernel_view(ts, cfg)
    assert torch.equal(view.perm, ts.bvh.tri_order.long()) and view.cluster_k == 0
    assert torch.equal(clusters.kernel_perm(ts, cfg), view.perm)
    tabs = pack_tables(ts, ts.diffuse, cfg)
    assert torch.equal(tabs.tri_index, ts.bvh.tri_order)
    assert torch.equal(tabs.planes, pack_tables(ts, ts.diffuse).planes[view.perm])
    inner = (ts.bvh.n_prims == 0).nonzero().flatten()
    assert torch.equal(tabs.nodes, node_rows(ts.bvh)) and tabs.nodes.shape == (1 + len(inner), 16)
    bits = tabs.nodes.view(torch.int32)
    left, right = inner + 1, inner + ts.bvh.right_offset[inner]
    assert torch.equal(bits[1:, 6] >= 0, ts.bvh.n_prims[left] == 0)
    assert torch.equal(bits[1:, 7] >= 0, ts.bvh.n_prims[right] == 0)
    for cols, kids in (((0, 3, 6), torch.cat([left.new_zeros(1), left])),
                       ((8, 11, 14), right)):
        rows = tabs.nodes if cols[0] == 0 else tabs.nodes[1:]
        lo, hi = rows[:, cols[0]:cols[1]], rows[:, cols[1]:cols[2]]
        assert bool((lo < ts.bvh.bbox_min[kids]).all()) and bool((hi > ts.bvh.bbox_max[kids]).all())
    assert not forward._use_staged(cfg, ts) and forward._use_staged(RenderConfig(), ts)
    plain = large_scene()
    assert clusters.kernel_view(plain, cfg).cluster_k > 0  # no BVH: the sweep
    assert not clusters.uses_bvh(ts, RenderConfig(intersect="brute"))


def test_trees_the_traversal_cannot_take_are_refused():
    scene = large_scene()
    bvh = build_bvh(scene)
    check_bvh(bvh, scene.n_tri)
    inner = int((bvh.n_prims == 0).nonzero()[0])
    bad_link = bvh.right_offset.clone()
    bad_link[inner] = bvh.n_nodes
    bad_leaf = bvh.start.clone()
    bad_leaf[int((bvh.n_prims > 0).nonzero()[0])] = scene.n_tri
    order = bvh.tri_order.clone()
    order[0] = order[1]
    assert int(bvh.n_prims[1]) == 0
    shared = bvh.right_offset.clone()
    shared[0] = 2  # node 2, node 1's left child, also the root's right
    for tree, what in ((bvh._replace(right_offset=bad_link), "children"),
                       (bvh._replace(right_offset=shared), "exactly one"),
                       (bvh._replace(start=bad_leaf), "leaf"),
                       (bvh._replace(tri_order=order), "permutation")):
        with pytest.raises(ValueError, match=what):
            check_bvh(tree, scene.n_tri)
    # A chain of MAX_STACK inner nodes, each with a leaf as its right child.
    m = 2 * MAX_STACK + 1
    start = torch.zeros(m, dtype=torch.int32)
    n_prims = torch.zeros(m, dtype=torch.int32)
    right = torch.zeros(m, dtype=torch.int32)
    for i in range(MAX_STACK):
        right[2 * i] = 2
        n_prims[2 * i + 1] = 1
    n_prims[-1] = 1
    deep = BVHData(torch.zeros((m, 3)), torch.ones((m, 3)), start, n_prims, right,
                   torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="deep"):
        check_bvh(deep, 1)
    # A tree enters the port checked: a JAX scene's malformed BVH is
    # refused on conversion (the traversals would read out of range), and
    # the route's tables refuse a tree over another triangle count.
    fields = {f.name: getattr(scene, f.name).numpy() for f in dataclasses.fields(scene)
              if f.name != "bvh"}
    fields["bvh"] = tuple(t.numpy() for t in bvh._replace(right_offset=bad_link))
    with pytest.raises(ValueError, match="children"):
        scene_from_numpy(fields)
    fields["bvh"] = tuple(t.numpy() for t in bvh)
    assert scene_from_numpy(fields).bvh.n_nodes == bvh.n_nodes
    with pytest.raises(ValueError, match="orders"):
        pack_tables(scene.replace(bvh=bvh._replace(tri_order=bvh.tri_order[:-1])), scene.diffuse,
                    RenderConfig(intersect="bvh"))
    assert node_rows(bvh).shape == (1 + bvh.n_nodes // 2, 16)


def test_cli_render_intersect_bvh_writes_the_sweeps_image(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--width", "8", "--height", "8", "--spp", "2", "--bounces", "3", "--cpu"]
    cli.main(["render", SCENE0, "sweep.png", *args])
    cli.main(["render", SCENE0, "bvh.png", "--intersect", "bvh", *args])
    assert np.array_equal(read_png("sweep.png"), read_png("bvh.png"))
    with pytest.raises(SystemExit):
        cli.main(["render", SCENE0, "x.png", "--intersect", "kd", *args])
    assert load_scene(SCENE0, asset_root=ASSET_ROOT, with_bvh=True).bvh is not None

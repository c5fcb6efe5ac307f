"""Tests of the port that need the card.  They skip without a CUDA device.

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has no JAX (tests/conftest.py imports it, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: radiance and records rtol 1e-4 / atol 1e-5 and equal ray
counts, kernel against its plain version on the same inputs; the material
gradient rtol 1e-4 with an absolute floor of 1e-6 of its largest entry (the
kernels and the plain one-hot contraction sum in different orders).  The
inverse kernels: B5's grid rtol 1e-4 with the same floor (shared-memory
atomics add in no fixed order) and visit counts equal; B6's hit and nee_ok
rows equal and its other rows within rtol 1e-4 / atol 1e-5 where their mask
is set.  B6's global-grid sink: its float64 grid against B6's records
reduced by grids_from_edge_records on the same rays, the same float32
quantities summed in float64 in another order: rtol 1e-9 with an absolute
floor of 1e-12 of the largest entry, visit counts equal.
"""

import os

import pytest
import torch

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, load_scene, render_samples
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    grad_tile,
    grad_tile_plain,
    render_tile,
    render_tile_plain,
    render_tile_rec,
    render_tile_rec_plain,
    reverse_tile,
    reverse_tile_plain,
)
from inverse_path_tracer_torch.render.forward import camera_rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
RTOL, ATOL = 1e-4, 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture()
def scene0(card):
    return load_scene(SCENE0, asset_root=ASSET_ROOT).to(card)


def tile_args(scene, cfg, card, mode):
    n = cfg.n_samples
    idx = torch.arange(n, device=card)
    p, d = camera_rays(scene, cfg, 5, idx)
    args = dict(p=p.T.contiguous(), d=d.T.contiguous(),
                alive=torch.ones((1, n), device=card),
                orig=idx.to(torch.int32)[None, :].contiguous())
    if mode == "external":
        g = torch.Generator(device="cpu").manual_seed(1)
        args["uniforms"] = torch.rand((cfg.max_bounces * 8, n), generator=g).to(card)
    else:
        args["keys"] = rng.key_words(5)
    return args


def assert_grad_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("mode", ["external", "fused"])
def test_kernel_matches_plain(card, scene0, mode, quirks):
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8, reference_quirks=quirks)
    args = tile_args(scene0, cfg, card, mode)
    before = render_tile.launches
    rk, sk = render_tile(scene0.diffuse, scene0, cfg, **args)
    rp, sp = render_tile_plain(scene0.diffuse, scene0, cfg, **args)
    assert render_tile.launches == before + 1
    torch.testing.assert_close(rk, rp, rtol=RTOL, atol=ATOL)
    assert torch.equal(sk, sp)


def test_render_samples_goes_through_the_kernel(card, scene0):
    cfg = RenderConfig(width=16, height=16, spp=8, max_bounces=6, tile_size=700)
    before = render_tile.launches
    vals, st = render_samples(scene0.diffuse, scene0, 2, cfg)  # device=None: the card
    assert render_tile.launches == before + 3  # 2048 samples in launches of 700
    assert vals.device.type == "cuda" and torch.isfinite(vals).all()
    plain, pst = render_samples(scene0.diffuse, scene0, 2, cfg.with_(backend="plain"))
    torch.testing.assert_close(vals, plain, rtol=RTOL, atol=ATOL)
    assert int(st.segments) == int(pst.segments) and int(st.shadow_rays) == int(pst.shadow_rays)


def test_emitter_free_scene_and_dead_lanes(card):
    """No emitters: black, no shadow rays.  A range past the last sample:
    the dead lanes stay zero and the live ones equal the full render."""
    from inverse_path_tracer_torch import build_scene, render_range
    from inverse_path_tracer_torch.scene.dsl import ObjectParams

    cube = build_scene([ObjectParams(pos=(0, -1.5, 4), obj_file="shapes/cube.obj",
                                     mtl_file="*Kd 0.5 0.5 0.5*")], asset_root=ASSET_ROOT)
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=4)
    vals, st = render_samples(cube.diffuse, cube, 0, cfg)
    assert not vals.any() and int(st.shadow_rays) == 0 and int(st.segments) > 0

    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    full, _ = render_samples(scene.diffuse, scene, 4, cfg)
    tail, _ = render_range(scene.diffuse, scene, 4, cfg, cfg.n_samples - 100, 300)
    assert not tail[100:].any()
    torch.testing.assert_close(tail[:100], full[-100:], rtol=0, atol=0)


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("mode", ["external", "fused"])
def test_gradient_kernels_match_plain(card, scene0, mode, quirks):
    """B3's radiance and counts are B1's; its records, B2 and B4 match their
    plain versions; B4 on B3's records gives B2's gradient."""
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8, reference_quirks=quirks)
    args = tile_args(scene0, cfg, card, mode)
    g = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(2)).to(card)
    mats = scene0.diffuse
    before = (render_tile_rec.launches, grad_tile.launches, reverse_tile.launches)
    rad, st, rec = render_tile_rec(mats, scene0, cfg, **args)
    d_b2 = grad_tile(mats, scene0, cfg, g=g, **args)
    d_b4 = reverse_tile(scene0.n_tri, cfg, rec, g)
    assert (render_tile_rec.launches, grad_tile.launches, reverse_tile.launches) == tuple(
        k + 1 for k in before)
    rad1, st1 = render_tile(mats, scene0, cfg, **args)
    assert torch.equal(rad, rad1) and torch.equal(st, st1)
    _, _, rec_p = render_tile_rec_plain(mats, scene0, cfg, **args)
    torch.testing.assert_close(rec, rec_p, rtol=RTOL, atol=ATOL)
    assert_grad_close(d_b2, grad_tile_plain(mats, scene0, cfg, g=g, **args))
    assert_grad_close(d_b4, reverse_tile_plain(scene0.n_tri, cfg, rec, g))
    torch.testing.assert_close(d_b4, d_b2, rtol=1e-6, atol=0)
    assert bool(torch.isfinite(d_b2).all()) and float(d_b2.abs().sum()) > 0


def assert_vn_grad_close(got, want):
    """The JAX tests' bound for a vertex-normal scene's gradient
    (tests/test_pallas.py:263-270): at most 6 triangle rows differ, the
    totals agree to 1e-3 and the L1 difference is under 1e-2 of the L1 mass."""
    rows_off = int((~torch.isclose(got, want, rtol=2e-4, atol=1e-7).all(dim=1)).sum())
    assert rows_off <= 6
    torch.testing.assert_close(got.sum(0), want.sum(0), rtol=1e-3, atol=0)
    assert float((got - want).abs().sum()) <= 1e-2 * float(want.abs().sum()) + 1e-6


@pytest.mark.parametrize("kind", ["scene0", "sphere"])
def test_regenerating_gradient_kernels(card, tmp_path, kind):
    """B2 and B3 on their persistent schedule with regenerating lanes, with
    a few dead lanes: B3's radiance and counts equal B1's, its whole record
    array (the zeros past each ray's last bounce included) matches the plain
    version, and B2 matches the plain gradient and is bit-equal across two
    calls; on scene 0 (dense) and the clustered 242-triangle sphere scene
    (records: at least 97% of lanes, the gradient under the vertex-normal
    bound, as the JAX tests hold such scenes)."""
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables

    scene = (load_scene(SCENE0, asset_root=ASSET_ROOT).to(card) if kind == "scene0"
             else sphere_scene(card, tmp_path))
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8)
    n = cfg.n_samples
    args = tile_args(scene, cfg, card, "fused")
    args["alive"][0, -7:] = 0.0
    tabs = pack_tables(scene, scene.diffuse, cfg)
    assert (tabs.cluster_k > 0) is (kind == "sphere")
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(8)).to(card)
    mats = scene.diffuse
    before = (render_tile_rec.launches, grad_tile.launches)
    rad, st, rec = render_tile_rec(mats, scene, cfg, tables=tabs, **args)
    d1 = grad_tile(mats, scene, cfg, g=g, tables=tabs, **args)
    d2 = grad_tile(mats, scene, cfg, g=g, tables=tabs, **args)
    assert (render_tile_rec.launches, grad_tile.launches) == (before[0] + 1, before[1] + 2)
    assert render_tile_rec.blocks >= 1 and grad_tile.blocks >= 1
    r1, s1 = render_tile(mats, scene, cfg, tables=tabs, **args)
    assert torch.equal(rad, r1) and torch.equal(st, s1)
    assert torch.equal(d1, d2)
    assert not rad[:, -7:].any() and not st[:, -7:].any() and not rec[:, -7:].any()
    past = torch.arange(cfg.max_bounces, device=card)[:, None] >= st[0].long()[None, :]
    assert not rec.view(cfg.max_bounces, 16, n).abs().amax(dim=1)[past].any()
    _, _, rec_p = render_tile_rec_plain(mats, scene, cfg, **args)
    dp = grad_tile_plain(mats, scene, cfg, g=g, **args)
    if kind == "scene0":
        torch.testing.assert_close(rec, rec_p, rtol=RTOL, atol=ATOL)
        assert_grad_close(d1, dp)
    else:
        close = torch.isclose(rec, rec_p, rtol=RTOL, atol=ATOL).all(dim=0).float().mean()
        assert float(close) >= 0.97
        assert_vn_grad_close(d1, dp)
    assert bool(torch.isfinite(d1).all()) and float(d1.abs().sum()) > 0


def test_recovery_resume_is_bit_identical_on_the_card(card, scene0, tmp_path):
    """Recovery through B2: 2 steps, a checkpoint and a resume to 4 equal 4
    uninterrupted steps bit for bit."""
    from inverse_path_tracer_torch import recover_materials, render_image

    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=6)
    target = render_image(scene0.diffuse, scene0, 100, cfg)
    run = lambda steps, **kw: recover_materials(scene0, target, cfg, steps=steps, lr=0.1, key=1,
                                                **kw)
    before = grad_tile.launches
    whole, whole_losses = run(4)
    assert grad_tile.launches == before + 4
    ckpt = str(tmp_path / "recover.npz")
    run(2, checkpoint_path=ckpt, checkpoint_every=2)
    resumed, tail_losses = run(4, checkpoint_path=ckpt, checkpoint_every=2, resume=True)
    assert torch.equal(resumed, whole) and tail_losses == whole_losses[2:]


def test_backward_goes_through_render_bwd(card, scene0):
    from inverse_path_tracer_torch import loss_and_grad_range
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    cfg = RenderConfig(width=16, height=16, spp=8, max_bounces=6, tile_size=1024)
    n = cfg.n_samples
    grads = {}
    for backend in ("auto", "plain"):
        m = scene0.diffuse.clone().requires_grad_()
        before = (render_tile.launches, grad_tile.launches)
        vals, _ = render_samples(m, scene0, 2, cfg.with_(backend=backend))
        tonemap_mean(vals, cfg.spp).mean().backward()
        launched = (render_tile.launches - before[0], grad_tile.launches - before[1])
        assert launched == ((2, 2) if backend == "auto" else (0, 0))
        grads[backend] = m.grad
    assert_grad_close(grads["auto"], grads["plain"])

    before = (render_tile_rec.launches, reverse_tile.launches)
    loss, d_mats, _ = loss_and_grad_range(
        scene0.diffuse, scene0, 2, cfg, 0, n,
        lambda v, lo: tonemap_mean(v, cfg.spp).sum() / (n // cfg.spp * 3))
    assert (render_tile_rec.launches - before[0], reverse_tile.launches - before[1]) == (2, 2)
    torch.testing.assert_close(d_mats, grads["auto"], rtol=1e-5, atol=1e-9)


def grid_close(got, want):
    """Grids: rtol 1e-4 with an absolute floor of 1e-6 of the largest entry
    (shared-memory atomics add in no fixed order), visit counts equal."""
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got[..., 8], want[..., 8])


def grid64_close(got, want):
    """Float64 grids of the same float32 quantities summed in different
    orders: rtol 1e-9 with an absolute floor of 1e-12 of the largest entry
    (a float32 sum misses it), visit counts equal."""
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12 * float(want.abs().max()))
    assert torch.equal(got[..., 8], want[..., 8])


def sphere_scene(card, tmp_path):
    from inverse_path_tracer_torch import build_scene
    from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
    from inverse_path_tracer_torch.scene.dsl import ObjectParams

    obj = tmp_path / "sphere.obj"
    obj.write_text(sphere_obj_text(rings=8, segments=16))
    box = ObjectParams(pos=(0, 0, 4), scl=(2, 2, 2), obj_file="CornellBox/CornellBox-Empty-CO.obj",
                       mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    ball = ObjectParams(pos=(0, -1.5, 4), obj_file=str(obj), mtl_file="*Kd 0.5 0.5 0.5*")
    return build_scene([box, ball], asset_root=ASSET_ROOT).to(card)


def assert_records_match(rec, rec_p):
    r, q = rec.view(-1, 8, rec.shape[1]), rec_p.view(-1, 8, rec.shape[1])
    assert torch.equal(r[:, 2], q[:, 2]) and torch.equal(r[:, 4], q[:, 4])
    hit, ok = q[:, 2] > 0, q[:, 4] > 0
    for row, mask in ((0, hit), (1, hit), (3, hit), (5, ok), (6, ok)):
        torch.testing.assert_close(r[:, row][mask], q[:, row][mask], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["external", "fused"])
def test_inverse_kernels_match_plain(card, scene0, mode):
    """B5 and B6 against their plain versions, and B5's grid against B6's
    records reduced."""
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        grids_from_edge_records,
        inverse_tile,
        inverse_tile_plain,
        inverse_tile_rec,
        inverse_tile_rec_plain,
    )

    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8)
    args = tile_args(scene0, cfg, card, mode)
    pix = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(4)).to(card)
    before = (inverse_tile.launches, inverse_tile_rec.launches)
    grid, st = inverse_tile(scene0, cfg, pix=pix, **args)
    rec, st_r = inverse_tile_rec(scene0, cfg, **args)
    assert (inverse_tile.launches, inverse_tile_rec.launches) == tuple(k + 1 for k in before)
    grid_p, st_p = inverse_tile_plain(scene0, cfg, pix=pix, **args)
    rec_p, _ = inverse_tile_rec_plain(scene0, cfg, **args)
    grid_close(grid, grid_p)
    assert torch.equal(st, st_p) and torch.equal(st_r, st_p)
    assert_records_match(rec, rec_p)
    reduced = grids_from_edge_records(rec, pix.T, scene0, cfg).float()
    torch.testing.assert_close(grid, reduced, rtol=1e-4, atol=1e-6 * float(reduced.abs().max()))
    assert float(grid[..., 8].sum()) > cfg.n_samples


def test_inverse_records_kernel_on_a_vertex_normal_scene(card, tmp_path, monkeypatch):
    """B6's records sink on the 242-triangle sphere scene, clustered (the
    auto layout) and with the dense sweep."""
    from inverse_path_tracer_torch.ops.kernels import clusters
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        inverse_grid_fits,
        inverse_tile,
        inverse_tile_rec,
        inverse_tile_rec_plain,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables

    scene = sphere_scene(card, tmp_path)
    assert scene.has_vertex_normals and not inverse_grid_fits(scene)
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8)
    args = tile_args(scene, cfg, card, "fused")
    pix = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(5)).to(card)
    for dense in (False, True):
        if dense:
            monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 1 << 30)
        assert (pack_tables(scene, scene.diffuse, cfg).cluster_k == 0) is dense
        rec, st = inverse_tile_rec(scene, cfg, **args)
        rec_p, st_p = inverse_tile_rec_plain(scene, cfg, **args)
        assert_records_match(rec, rec_p)
        assert torch.equal(st, st_p)
    with pytest.raises(ValueError, match="shared memory"):
        inverse_tile(scene, cfg, pix=pix, **args)


@pytest.mark.parametrize("mode", ["external", "fused"])
@pytest.mark.parametrize("kind", ["scene0", "sphere", "sphere_dense", "large"])
def test_global_grid_matches_reduced_records(card, tmp_path, monkeypatch, kind, mode):
    """B6's global-grid sink against B6's records reduced on the same rays
    (clustered on the sphere and large scenes, whose grids are mapped back;
    sphere_dense: the sphere with the dense sweep), and the per-ray counts
    of both sinks (and of B5 where its grid fits) equal to their plain
    versions."""
    from inverse_path_tracer_torch import large_scene
    from inverse_path_tracer_torch.ops.kernels import clusters
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        grids_from_edge_records,
        inverse_grid_fits,
        inverse_tile,
        inverse_tile_global,
        inverse_tile_rec,
        inverse_tile_rec_plain,
        unperm_grid,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables

    scene = {"scene0": lambda: load_scene(SCENE0, asset_root=ASSET_ROOT).to(card),
             "sphere": lambda: sphere_scene(card, tmp_path),
             "sphere_dense": lambda: sphere_scene(card, tmp_path),
             "large": lambda: large_scene(card)}[kind]()
    if kind == "sphere_dense":
        monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 1 << 30)
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8)
    args = tile_args(scene, cfg, card, mode)
    pix = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(7)).to(card)
    tabs = pack_tables(scene, scene.diffuse, cfg)
    assert (tabs.cluster_k > 0) is (kind in ("sphere", "large"))  # 242 and 1298 triangles
    before = inverse_tile_global.launches
    acc, st_g = inverse_tile_global(scene, cfg, pix=pix, tables=tabs, **args)
    assert inverse_tile_global.launches == before + 1
    rec, st_r = inverse_tile_rec(scene, cfg, tables=tabs, **args)
    _, st_p = inverse_tile_rec_plain(scene, cfg, **args)
    grid64_close(unperm_grid(acc, tabs.perm),
                 grids_from_edge_records(rec, pix.T, scene, cfg, tabs.perm))
    assert torch.equal(st_g, st_p) and torch.equal(st_r, st_p)
    if inverse_grid_fits(scene):
        _, st5 = inverse_tile(scene, cfg, pix=pix, tables=tabs, **args)
        assert torch.equal(st5, st_p)
    assert float(acc[..., 8].sum()) > cfg.n_samples


def test_extraction_routes_and_p_spec(card, scene0):
    """extract_graph on the card goes through B5; p_spec > 0 needs
    backend="plain" on CUDA tensors, and the kernel route agrees with the
    plain wavefront path."""
    from inverse_path_tracer_torch import trace_transport_range
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import inverse_tile

    cfg = RenderConfig(width=16, height=16, spp=8, max_bounces=6, tile_size=1000)
    img = torch.rand((16, 16, 3), generator=torch.Generator().manual_seed(6))
    before = inverse_tile.launches
    auto, stats = trace_transport_range(scene0, img, 3, cfg, 0, cfg.n_samples)
    assert inverse_tile.launches == before + 3  # 2048 samples in launches of 1000
    plain, plain_stats = trace_transport_range(scene0, img, 3, cfg.with_(backend="plain"), 0,
                                               cfg.n_samples)
    assert torch.equal(auto.count, plain.count)
    assert [int(x) for x in stats] == [int(x) for x in plain_stats]
    torch.testing.assert_close(auto.w_sum, plain.w_sum, rtol=1e-4, atol=1e-5)
    for f in ("pixel_sum", "light_sum", "factors_sum"):  # the DIFFUSE channel
        torch.testing.assert_close(getattr(auto, f)[:, 0], getattr(plain, f)[:, 0], rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="p_spec"):
        trace_transport_range(scene0, img, 3, cfg.with_(p_spec=0.25), 0, cfg.n_samples)
    spec, _ = trace_transport_range(scene0, img, 3, cfg.with_(p_spec=0.25, backend="plain"), 0,
                                    cfg.n_samples)
    assert bool(torch.isfinite(spec.w_sum).all())


def assert_carry_equal(got, want):
    """Carries of a kernel and its plain version: equal, with the pending
    hit compared only where the lane is alive (a dead lane's point may
    differ in its last bits, which nothing reads)."""
    live = want[17] > 0
    rows = [r for r in range(24) if r not in (3, 4, 5)]
    assert torch.equal(got[rows], want[rows])
    torch.testing.assert_close(got[3:6, live], want[3:6, live], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,cluster_k", [("external", 0), ("fused", 0), ("fused", 768)])
def test_staged_kernels_match_plain(card, mode, cluster_k):
    """B7, B8 (stage 0 and a partial last stage, with and without records,
    with and without the live-lane count), B9 and B10 against their plain
    versions on the flat large scene, at the auto cluster width and at JAX's
    layout (768)."""
    from inverse_path_tracer_torch import large_scene
    from inverse_path_tracer_torch.ops.kernels import clusters
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        intersect_tile,
        intersect_tile_plain,
        pack_tables,
    )
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        init_tile,
        init_tile_plain,
        stage_reverse_tile,
        stage_reverse_tile_plain,
        stage_tile,
        stage_tile_plain,
    )

    scene = large_scene(card, vertex_normals=False)
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=6, stage_bounces=4,
                       cluster_k=cluster_k)
    args = tile_args(scene, cfg, card, mode)
    n, k = cfg.n_samples, 4
    tabs = pack_tables(scene, scene.diffuse, cfg)
    assert tabs.cluster_k == (cluster_k or clusters.CLUSTER_AUTO_K) and tabs.perm is not None
    mats = scene.diffuse
    before = (init_tile.launches, stage_tile.launches, stage_reverse_tile.launches,
              intersect_tile.launches)
    carry = init_tile(mats, scene, cfg, args["p"], args["d"], args["alive"], tables=tabs)
    assert_carry_equal(carry, init_tile_plain(mats, scene, cfg, args["p"], args["d"],
                                              args["alive"]))
    u = args.get("uniforms")
    u = None if u is None else torch.cat([u, torch.zeros_like(u[:16])])
    suf = torch.zeros((4, n), device=card)
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(3)).to(card)
    for s in range(2):
        u_s = None if u is None else u[s * 32 : (s + 1) * 32].contiguous()
        st = (mats, scene, cfg, carry, args["orig"], s * k, k, u_s, args.get("keys"))
        out, rec = stage_tile(*st, with_rec=True, tables=tabs)
        out_p, rec_p = stage_tile_plain(*st, with_rec=True)
        assert_carry_equal(out, out_p)
        assert torch.equal(rec, rec_p)
        assert torch.equal(stage_tile(*st, tables=tabs), out)
        # Live lanes first and their count on the device: the same stage.
        order = torch.sort((carry[17] <= 0).to(torch.int32), stable=True).indices
        live = (carry[17] > 0).sum(dtype=torch.int32).reshape(1)
        st_sorted = (mats, scene, cfg, carry[:, order].contiguous(),
                     args["orig"][:, order].contiguous(), s * k, k,
                     None if u_s is None else u_s[:, order].contiguous(), args.get("keys"))
        out_l, rec_l = stage_tile(*st_sorted, with_rec=True, tables=tabs, live=live)
        assert torch.equal(out_l, out[:, order]) and torch.equal(rec_l, rec[:, order])
        dm, suf_out = stage_reverse_tile(scene.n_tri, cfg, k, rec, g, suf)
        dm_p, suf_p = stage_reverse_tile_plain(scene.n_tri, cfg, k, rec, g, suf)
        assert_grad_close(dm, dm_p)
        torch.testing.assert_close(suf_out, suf_p, rtol=1e-6, atol=0)
        carry, suf = out, suf_out
    t, idx = intersect_tile(scene, cfg, args["p"], args["d"], tables=tabs)
    t_p, idx_p = intersect_tile_plain(scene, cfg, args["p"], args["d"])
    assert torch.equal(t, t_p) and torch.equal(idx, idx_p)
    after = (init_tile.launches, stage_tile.launches, stage_reverse_tile.launches,
             intersect_tile.launches)
    # B10 ran inside B7 and the six B8 launches, and once alone.
    assert tuple(a - b for a, b in zip(after, before)) == (1, 6, 2, 8)


def test_staged_render_and_gradients_on_the_card(card):
    """The staged path equals the mega path on the card and the plain
    staged path; its gradient and loss_and_grad_range's agree."""
    from inverse_path_tracer_torch import large_scene, loss_and_grad_range
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import init_tile, stage_tile
    from inverse_path_tracer_torch.ops.tonemap import tonemap_mean

    scene = large_scene(card, vertex_normals=False)
    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=6, tile_size=512)
    before = (init_tile.launches, stage_tile.launches)
    staged, st = render_samples(scene.diffuse, scene, 2, cfg)
    assert (init_tile.launches - before[0], stage_tile.launches - before[1]) == (2, 4)
    mega, sm = render_samples(scene.diffuse, scene, 2, cfg.with_(wavefront="mega"))
    plain, sp = render_samples(scene.diffuse, scene, 2, cfg.with_(backend="plain"))
    assert torch.equal(staged, mega) and torch.equal(staged, plain)
    assert [int(x) for x in st] == [int(x) for x in sm] == [int(x) for x in sp]
    grads = {}
    for name, c in (("staged", cfg), ("mega", cfg.with_(wavefront="mega")),
                    ("plain", cfg.with_(backend="plain"))):
        m = scene.diffuse.clone().requires_grad_()
        vals, _ = render_samples(m, scene, 2, c)
        tonemap_mean(vals, cfg.spp).mean().backward()
        grads[name] = m.grad
    assert_grad_close(grads["staged"], grads["plain"])
    assert_grad_close(grads["mega"], grads["plain"])
    n = cfg.n_samples
    _, d_mats, _ = loss_and_grad_range(
        scene.diffuse, scene, 2, cfg, 0, n,
        lambda v, lo: tonemap_mean(v, cfg.spp).sum() / (n // cfg.spp * 3))
    torch.testing.assert_close(d_mats, grads["staged"], rtol=1e-5, atol=1e-9)


def test_clustered_kernels_match_dense_plain(card, monkeypatch):
    """B1-B4 and B6 with clustered tables on the flat large scene against
    the plain versions of the dense sweep in global order; B5 with
    clustered tables on scene 0 (clusters of 8)."""
    from inverse_path_tracer_torch import large_scene
    from inverse_path_tracer_torch.ops.kernels import clusters
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        grids_from_edge_records,
        inverse_tile,
        inverse_tile_plain,
        inverse_tile_rec,
        inverse_tile_rec_plain,
    )
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables

    scene = large_scene(card, vertex_normals=False)
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8)
    args = tile_args(scene, cfg, card, "fused")
    g = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(2)).to(card)
    mats = scene.diffuse
    tabs = pack_tables(scene, mats, cfg)
    perm = tabs.perm
    rk, sk = render_tile(mats, scene, cfg, tables=tabs, **args)
    _, _, rec = render_tile_rec(mats, scene, cfg, tables=tabs, **args)
    d2 = grad_tile(mats, scene, cfg, g=g, tables=tabs, **args)
    d4 = reverse_tile(scene.n_tri, cfg, rec, g, perm)
    rec6, st6 = inverse_tile_rec(scene, cfg, tables=pack_tables(scene, mats, cfg), **args)
    pix = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(4)).to(card)
    grid6 = grids_from_edge_records(rec6, pix.T, scene, cfg, perm)
    monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 1 << 30)  # the dense sweep
    rp, sp = render_tile_plain(mats, scene, cfg, **args)
    _, _, rec_p = render_tile_rec_plain(mats, scene, cfg, **args)
    assert torch.equal(rk, rp) and torch.equal(sk, sp)
    r, q = rec.view(8, 16, -1), rec_p.view(8, 16, -1)
    hit = q[:, 14] > 0
    assert torch.equal(perm[r[:, 13].long()][hit], q[:, 13].long()[hit])  # tri, mapped back
    assert torch.equal(r[:, [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 15]],
                       q[:, [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 15]])
    want = grad_tile_plain(mats, scene, cfg, g=g, **args)
    assert_grad_close(d2, want)
    assert_grad_close(d4, want)
    grid_p, st_p = inverse_tile_plain(scene, cfg, pix=pix, **args)
    assert torch.equal(st6, st_p)
    grid_close(grid6.float(), grid_p)

    monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 8)
    scene0 = load_scene(SCENE0, asset_root=ASSET_ROOT).to(card)
    cfg8 = cfg.with_(cluster_k=8)
    args0 = tile_args(scene0, cfg8, card, "fused")
    grid, st5 = inverse_tile(scene0, cfg8, pix=pix, **args0)
    assert pack_tables(scene0, scene0.diffuse, cfg8).cluster_k == 8
    monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 1 << 30)
    grid_p0, st_p0 = inverse_tile_plain(scene0, cfg8, pix=pix, **args0)
    grid_close(grid, grid_p0)
    assert torch.equal(st5, st_p0)


def camera_launch(scene, cfg, card, key=5, base=0, n=None):
    """A fused launch in camera mode and the same launch with the plain
    camera_rays' rays on the card (ops/camera.py camera_inputs)."""
    from inverse_path_tracer_torch.ops.camera import Camera, camera_inputs

    cam = Camera(base, cfg.n_samples - base if n is None else n, key)
    keys = rng.key_words(key)
    return dict(camera=cam, keys=keys), dict(camera_inputs(scene, cfg, cam), keys=keys)


@pytest.mark.parametrize("kind", ["scene0", "sphere", "sphere_dense", "large"])
def test_camera_mode_equals_the_plain_camera_rays(card, tmp_path, monkeypatch, kind):
    """The rays the kernels make (camera mode) are the plain camera_rays',
    bit for bit: B1, B3, B2 and B7 in camera mode equal the same kernels fed
    those rays, with a launch past the last sample (dead lanes) and an odd
    width; B3 = B1 and B2 twice bit-equal with the new rays."""
    from inverse_path_tracer_torch import large_scene
    from inverse_path_tracer_torch.ops.kernels import clusters
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import init_tile

    scene = {"scene0": lambda: load_scene(SCENE0, asset_root=ASSET_ROOT).to(card),
             "sphere": lambda: sphere_scene(card, tmp_path),
             "sphere_dense": lambda: sphere_scene(card, tmp_path),
             "large": lambda: large_scene(card)}[kind]()
    if kind == "sphere_dense":
        monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 1 << 30)
    cfg = RenderConfig(width=30, height=17, spp=3, max_bounces=8)
    base = 11
    cam, rays = camera_launch(scene, cfg, card, base=base, n=cfg.n_samples - base + 40)
    mats = scene.diffuse
    tabs = pack_tables(scene, mats, cfg)
    n = cam["camera"].n
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(12)).to(card)
    before = (render_tile.launches, render_tile_rec.launches, grad_tile.launches)
    rc, sc = render_tile(mats, scene, cfg, tables=tabs, **cam)
    rr, sr = render_tile(mats, scene, cfg, tables=tabs, **rays)
    r3, s3, rec3 = render_tile_rec(mats, scene, cfg, tables=tabs, **cam)
    _, _, rec3r = render_tile_rec(mats, scene, cfg, tables=tabs, **rays)
    d1 = grad_tile(mats, scene, cfg, g=g, tables=tabs, **cam)
    d2 = grad_tile(mats, scene, cfg, g=g, tables=tabs, **cam)
    dr = grad_tile(mats, scene, cfg, g=g, tables=tabs, **rays)
    assert (render_tile.launches, render_tile_rec.launches, grad_tile.launches) == (
        before[0] + 2, before[1] + 2, before[2] + 3)
    assert torch.equal(rc, rr) and torch.equal(sc, sr)
    assert torch.equal(r3, rc) and torch.equal(s3, sc) and torch.equal(rec3, rec3r)
    assert torch.equal(d1, d2) and torch.equal(d1, dr)
    assert not rc[:, -40:].any() and not sc[:, -40:].any()
    carry = init_tile(mats, scene, cfg, camera=cam["camera"], tables=tabs)
    carry_r = init_tile(mats, scene, cfg, rays["p"], rays["d"], rays["alive"], tables=tabs)
    assert torch.equal(carry, carry_r)


@pytest.mark.parametrize("kind", ["scene0", "sphere"])
def test_inverse_camera_mode_equals_the_plain_camera_rays(card, tmp_path, kind):
    """B5, B6's records sink and its global-grid sink in camera mode, with
    the target image in place of the pixel colours, against the same
    kernels fed the plain camera_rays' rays and the pixels gathered on the
    host: records and counts bit-equal, grids within their tolerances."""
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        inverse_grid_fits,
        inverse_tile,
        inverse_tile_global,
        inverse_tile_rec,
    )

    scene = (load_scene(SCENE0, asset_root=ASSET_ROOT).to(card) if kind == "scene0"
             else sphere_scene(card, tmp_path))
    cfg = RenderConfig(width=24, height=20, spp=4, max_bounces=8)
    cam, rays = camera_launch(scene, cfg, card, key=9, base=5, n=cfg.n_samples)  # 5 dead lanes
    image = torch.rand((cfg.width * cfg.height, 3),
                       generator=torch.Generator().manual_seed(13)).to(card)
    idx = (rays["orig"][0].long() // cfg.spp).clamp(0, cfg.width * cfg.height - 1)
    pix = image[idx].T.contiguous()
    rec, st = inverse_tile_rec(scene, cfg, **cam)
    rec_r, st_r = inverse_tile_rec(scene, cfg, **rays)
    assert torch.equal(rec, rec_r) and torch.equal(st, st_r)
    acc, st_g = inverse_tile_global(scene, cfg, image=image, **cam)
    acc_r, _ = inverse_tile_global(scene, cfg, pix=pix, **rays)
    grid64_close(acc, acc_r)
    assert torch.equal(st_g, st_r)
    if inverse_grid_fits(scene):
        grid, st5 = inverse_tile(scene, cfg, image=image, **cam)
        grid_r, _ = inverse_tile(scene, cfg, pix=pix, **rays)
        grid_close(grid, grid_r)
        assert torch.equal(st5, st_r)


def test_persistent_stage_reverse(card):
    """B9 on its persistent grid: at most one partial per block and as many
    blocks as fit at once, bit-equal across two calls and between the
    preloaded slots (k <= 4) and the slot-by-slot loop (the same records
    with a fifth, empty slot), within the gradient tolerance of its plain
    version with a ragged lane count, and the (suf, esc) carry close to it;
    the loop also on a stage of 6 bounces."""
    from inverse_path_tracer_torch import large_scene
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        init_tile,
        stage_reverse_tile,
        stage_reverse_tile_plain,
        stage_tile,
    )
    from inverse_path_tracer_torch.render.diff import REC_ROWS

    scene = large_scene(card, vertex_normals=False)
    cfg = RenderConfig(width=37, height=29, spp=3, max_bounces=8)
    cam, _ = camera_launch(scene, cfg, card, key=3)
    n, k = cam["camera"].n, 4
    tabs = pack_tables(scene, scene.diffuse, cfg)
    carry = init_tile(scene.diffuse, scene, cfg, camera=cam["camera"], tables=tabs)
    orig = torch.arange(n, dtype=torch.int32, device=card)[None, :]
    _, rec = stage_tile(scene.diffuse, scene, cfg, carry, orig, 0, k, keys=cam["keys"],
                        with_rec=True, tables=tabs)
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(14)).to(card)
    suf = torch.rand((4, n), generator=torch.Generator().manual_seed(15)).to(card)
    suf[3] = (suf[3] > 0.5).float()
    dm, so = stage_reverse_tile(scene.n_tri, cfg, k, rec, g, suf)
    assert 1 <= stage_reverse_tile.blocks <= -(-n // 128)  # 4 warps a block (kB9Warps)
    dm2, so2 = stage_reverse_tile(scene.n_tri, cfg, k, rec, g, suf)
    assert torch.equal(dm, dm2) and torch.equal(so, so2)
    # The loop on the same records with a fifth slot no lane reaches: from a
    # zero carry (which a lane that ends inside the stage starts from) the
    # same bits as the preloaded instance.
    zero = torch.zeros_like(suf)
    rec5 = torch.cat([rec, torch.zeros_like(rec[:REC_ROWS])])
    dm3, so3 = stage_reverse_tile(scene.n_tri, cfg, k, rec, g, zero)
    dm4, so4 = stage_reverse_tile(scene.n_tri, cfg, k + 1, rec5, g, zero)
    assert torch.equal(dm3, dm4) and torch.equal(so3, so4)
    dm_p, so_p = stage_reverse_tile_plain(scene.n_tri, cfg, k, rec, g, suf)
    assert_grad_close(dm, dm_p)
    torch.testing.assert_close(so, so_p, rtol=1e-6, atol=0)
    _, rec6 = stage_tile(scene.diffuse, scene, cfg, carry, orig, 0, 6, keys=cam["keys"],
                         with_rec=True, tables=tabs)
    dm6, so6 = stage_reverse_tile(scene.n_tri, cfg, 6, rec6, g, suf)
    dm6_p, so6_p = stage_reverse_tile_plain(scene.n_tri, cfg, 6, rec6, g, suf)
    assert_grad_close(dm6, dm6_p)
    torch.testing.assert_close(so6, so6_p, rtol=1e-6, atol=0)


def test_camera_mode_past_2_32_samples(card, scene0):
    """Global sample indices past 2^32: the kernel's 64-bit pixel divides
    and its hash of the index's low 32 bits give camera_rays' rays, and
    B6's global-grid sink reads the pixels of the plain version's 64-bit
    indices."""
    cfg = RenderConfig(width=1 << 16, height=1 << 16, spp=2, max_bounces=6)
    cam, rays = camera_launch(scene0, cfg, card, key=8, base=(1 << 32) - 100, n=700)
    rc, sc = render_tile(scene0.diffuse, scene0, cfg, **cam)
    rr, sr = render_tile(scene0.diffuse, scene0, cfg, **rays)
    assert torch.equal(rc, rr) and torch.equal(sc, sr) and float(sc[0].sum()) > 0
    # The global-grid sink reads each lane's pixel at its 64-bit index
    # (a small image: 2^25 samples a pixel).
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        inverse_tile_global,
        inverse_tile_plain,
    )

    cfg = RenderConfig(width=16, height=16, spp=1 << 25, max_bounces=6)
    cam, _ = camera_launch(scene0, cfg, card, key=8, base=(1 << 32) - 100, n=700)
    image = torch.rand((cfg.width * cfg.height, 3),
                       generator=torch.Generator().manual_seed(16)).to(card)
    acc, st = inverse_tile_global(scene0, cfg, image=image, **cam)
    acc_p, st_p = inverse_tile_plain(scene0, cfg, image=image, kernel_order=True, **cam)
    grid64_close(acc, acc_p)
    assert torch.equal(st, st_p)


@pytest.mark.parametrize("max_bounces", [16, 20])
@pytest.mark.parametrize("kind", ["scene0", "sphere"])
def test_reverse_tile_on_records(card, tmp_path, kind, max_bounces):
    """B4 on B3's records with dead lanes and a ragged lane count, on scene 0
    (dense) and the clustered 242-triangle sphere scene: within the gradient
    tolerance of its plain version (the vertex-normal bound on the sphere)
    and of B9 run from a zero carry over the whole record array, and
    bit-equal across two calls."""
    from inverse_path_tracer_torch.ops.kernels.clusters import kernel_perm, unperm_rows
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import stage_reverse_tile

    scene = (load_scene(SCENE0, asset_root=ASSET_ROOT).to(card) if kind == "scene0"
             else sphere_scene(card, tmp_path))
    cfg = RenderConfig(width=37, height=29, spp=3, max_bounces=max_bounces)
    n = cfg.n_samples
    args = tile_args(scene, cfg, card, "fused")
    args["alive"][0, -9:] = 0.0
    tabs = pack_tables(scene, scene.diffuse, cfg)
    assert (tabs.cluster_k > 0) is (kind == "sphere")
    perm = kernel_perm(scene, cfg)
    _, st, rec = render_tile_rec(scene.diffuse, scene, cfg, tables=tabs, **args)
    assert int(st[0].max()) > 4  # the records reach past a stage's slots
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(17)).to(card)
    before = reverse_tile.launches
    d1 = reverse_tile(scene.n_tri, cfg, rec, g, perm)
    d2 = reverse_tile(scene.n_tri, cfg, rec, g, perm)
    assert reverse_tile.launches == before + 2
    assert torch.equal(d1, d2)
    d9, suf = stage_reverse_tile(scene.n_tri, cfg, max_bounces, rec, g,
                                 torch.zeros((4, n), device=card))
    want = reverse_tile_plain(scene.n_tri, cfg, rec, g, perm)
    close = assert_grad_close if kind == "scene0" else assert_vn_grad_close
    close(d1, want)
    close(unperm_rows(d9, perm), d1)
    assert bool(torch.isfinite(d1).all()) and float(d1.abs().sum()) > 0
    assert not bool(suf.isnan().any())


# sha256 of B9's outputs (partials summed, then the carry out) on
# b9_fixed_records, on the card at the time B9 took its one-group preload
# (stage_reverse_kernel<4>); and of the inputs, so that a change of the
# inputs' generator is told apart from a change of B9's bits.
B9_FIXED_INPUTS_SHA256 = "fde46707e3daf9af590a0f93d6acd663036a82d3e3a62c0bb1703875d65d471e"
B9_FIXED_OUTPUTS_SHA256 = "6c10a0f33c4739538963550c9b0bff84d5877cd045fe026660bf14a023325041"


def b9_fixed_records(card, n_tri, n=5000 + 17):
    """Records of a 4-slot stage for n lanes made with numpy from a seed
    (path lengths 0 to 4, the last slot an escape for ~30% of them), with g
    and a random (suf, esc) carry."""
    import numpy as np

    from inverse_path_tracer_torch.render.diff import REC_ROWS

    r = np.random.default_rng(23)
    k = 4
    lengths = r.integers(0, k + 1, size=n)
    rec = np.zeros((k, REC_ROWS, n), dtype=np.float32)
    for s in range(k):
        on = lengths > s
        rec[s, :13, on] = r.random((int(on.sum()), 13), dtype=np.float32)
        rec[s, 13, on] = r.integers(0, n_tri, size=int(on.sum()))
        last = on & (lengths == s + 1)
        esc = last & (r.random(n) < 0.3)
        rec[s, 14, on & ~esc] = 1.0
        rec[s, 15, esc] = 1.0
        rec[s, 0:3, esc] = 0.0
        rec[s, 6:9, esc] = 0.0
    g = r.random((3, n), dtype=np.float32)
    suf = r.random((4, n), dtype=np.float32)
    suf[3] = (suf[3] > 0.5).astype(np.float32)
    return tuple(torch.from_numpy(x).to(card) for x in (rec.reshape(k * REC_ROWS, n), g, suf))


def sha256(*ts):
    import hashlib

    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()


def test_stage_reverse_keeps_its_bits(card):
    """B9 on a fixed set of records (b9_fixed_records, 40 blocks whatever
    the card): its outputs keep the stored digest, so that a change of its
    arithmetic or sum order fails here; the preloaded instance (stages of
    at most 4 slots) equals the loop instance on the same records padded
    with empty slots (8 and 12 slots) from a zero carry, bit for bit; and
    it is within the gradient tolerance of the plain version."""
    from inverse_path_tracer_torch import large_scene
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        stage_reverse_tile,
        stage_reverse_tile_plain,
    )
    from inverse_path_tracer_torch.render.diff import REC_ROWS

    scene = large_scene(card, vertex_normals=False)
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=16)
    rec, g, suf = b9_fixed_records(card, scene.n_tri)
    k, n = rec.shape[0] // REC_ROWS, rec.shape[1]
    dm, so = stage_reverse_tile(scene.n_tri, cfg, k, rec, g, suf)
    assert stage_reverse_tile.blocks == 40
    assert ((sha256(rec, g, suf), sha256(dm, so))
            == (B9_FIXED_INPUTS_SHA256, B9_FIXED_OUTPUTS_SHA256))
    zero = torch.zeros_like(suf)
    a, sa = stage_reverse_tile(scene.n_tri, cfg, k, rec, g, zero)
    for pad in (4, 8):
        rec_p = torch.cat([rec, torch.zeros((pad * REC_ROWS, n), device=card)])
        b, sb = stage_reverse_tile(scene.n_tri, cfg, k + pad, rec_p, g, zero)
        assert torch.equal(a, b) and torch.equal(sa, sb)
    dm_p, so_p = stage_reverse_tile_plain(scene.n_tri, cfg, k, rec, g, suf)
    assert_grad_close(dm, dm_p)
    torch.testing.assert_close(so, so_p, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["scene0", "large", "sphere", "large_vn"])
def test_persistent_init_tile(card, tmp_path, kind):
    """B7 on its persistent grid (the tables staged once a block, fixed
    32-lane-chunk ranges), with a lane count that is a multiple neither of
    32 nor of the grid: the carry equals its plain version (flat scenes:
    scene 0 dense and the large scene clustered, with the dead lanes' pending
    point within rtol 1e-4; vertex-normal scenes: at least 97% of lanes), in
    camera mode (with lanes past the last sample) and fed rays (with dead
    lanes), bit-equal across two calls, with as many blocks as fit and at
    most one per 512 lanes (render_fwd.cu kInitThreads)."""
    from inverse_path_tracer_torch import large_scene
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import init_tile, init_tile_plain

    scene = {"scene0": lambda: load_scene(SCENE0, asset_root=ASSET_ROOT).to(card),
             "large": lambda: large_scene(card, vertex_normals=False),
             "sphere": lambda: sphere_scene(card, tmp_path),
             "large_vn": lambda: large_scene(card)}[kind]()
    cfg = RenderConfig(width=37, height=29, spp=3, max_bounces=8)
    cam, rays = camera_launch(scene, cfg, card, key=6, base=7, n=cfg.n_samples - 7 + 21)
    n = cam["camera"].n
    assert n % 32 and (n - 21) % 32
    rays["alive"][0, 100:140] = 0.0
    mats = scene.diffuse
    tabs = pack_tables(scene, mats, cfg)
    assert (tabs.cluster_k > 0) is (kind != "scene0")
    before = init_tile.launches
    carry = init_tile(mats, scene, cfg, camera=cam["camera"], tables=tabs)
    assert init_tile.launches == before + 1 and 1 <= init_tile.blocks <= -(-n // 512)
    assert torch.equal(init_tile(mats, scene, cfg, camera=cam["camera"], tables=tabs), carry)
    carry_r = init_tile(mats, scene, cfg, rays["p"], rays["d"], rays["alive"], tables=tabs)
    want = init_tile_plain(mats, scene, cfg, camera=cam["camera"])
    want_r = init_tile_plain(mats, scene, cfg, rays["p"], rays["d"], rays["alive"])
    assert not carry[17, -21:].any() and not carry_r[17, 100:140].any()
    for got, exp in ((carry, want), (carry_r, want_r)):
        if kind in ("scene0", "large"):
            assert_carry_equal(got, exp)
        else:
            close = torch.isclose(got, exp, rtol=RTOL, atol=ATOL).all(dim=0).float().mean()
            assert float(close) >= 0.97


def test_batched_recovery_scene_chunk_on_the_card(card, scene0):
    """recover_materials_batched through B1 and B2 gives the same bits for
    every scene_chunk (models/recover.py batched_step)."""
    from inverse_path_tracer_torch import recover_materials_batched, render_image

    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=6)
    targets = torch.stack([render_image(scene0.diffuse * f, scene0, 3, cfg, device=card)
                           for f in (1.0, 0.5, 0.8)])
    run = lambda chunk: recover_materials_batched(scene0, targets, cfg, steps=2, lr=0.1, key=4,
                                                  scene_chunk=chunk, device=card)
    render_tile.launches = grad_tile.launches = 0
    whole, losses = run(0)
    assert render_tile.launches == grad_tile.launches == 6  # 3 scenes x 2 steps, 1 launch each
    assert whole.device.type == "cuda" and bool(torch.isfinite(whole).all())
    for chunk in (1, 2):
        mats, chunk_losses = run(chunk)
        assert torch.equal(mats, whole) and chunk_losses == losses


def test_cli_render_on_the_card(card, tmp_path):
    """cli.main render without --cpu renders through B1 and writes the PNG."""
    from inverse_path_tracer_torch import cli
    from inverse_path_tracer_torch.utils.png import read_png

    out = str(tmp_path / "0.png")
    render_tile.launches = 0
    cli.main(["render", SCENE0, out, "--width", "64", "--height", "48", "--spp", "4",
              "--tile", "4096"])
    assert render_tile.launches == 3  # 64 x 48 x 4 samples in launches of 4096
    img = read_png(out)
    assert img.shape == (48, 64, 3) and img.max() > 0


def test_intersect_bvh_on_the_card(card):
    """ops/bvh.py intersect_bvh on CUDA tensors: the dense plain sweep's
    hits on the large scene (rays from inside the box and from the camera),
    t bit-equal (the same triangle test), and the CPU traversal's."""
    from inverse_path_tracer_torch import large_scene
    from inverse_path_tracer_torch.ops.bvh import build_bvh, intersect_bvh
    from inverse_path_tracer_torch.ops.intersect import intersect_fast

    scene = large_scene(card)
    bvh = build_bvh(scene)
    g = torch.Generator(device="cpu").manual_seed(3)
    n = 1 << 15
    p_box = (torch.rand((n, 3), generator=g) * 3.6 - 1.8 + torch.tensor([0.0, 0.0, 4.0])).to(card)
    d_box = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1).to(card)
    cfg = RenderConfig(width=128, height=64, spp=4)
    p_cam, d_cam = camera_rays(scene, cfg, 2, torch.arange(n, device=card))
    for p, d in ((p_box, d_box), (p_cam, d_cam)):
        got = intersect_bvh(scene, bvh, p, d)
        want = intersect_fast(scene, p, d)
        assert got.t.device.type == "cuda" and int(want.hit.sum()) > n // 2
        assert torch.equal(got.hit, want.hit) and torch.equal(got.tri, want.tri)
        assert torch.equal(got.t, want.t)
        cpu = intersect_bvh(scene.to("cpu"), bvh.to("cpu"), p.cpu(), d.cpu())
        assert torch.equal(cpu.tri, got.tri.cpu()) and torch.equal(cpu.t, got.t.cpu())


def test_world1_nccl_sharded_render(card):
    """A process group of one rank on the card chooses NCCL, and
    render_samples_sharded there equals render_samples bit for bit."""
    import socket

    from inverse_path_tracer_torch.parallel.multihost import init_distributed, shutdown_distributed
    from inverse_path_tracer_torch.parallel.shard import make_mesh, render_samples_sharded

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert info["backend"] == "nccl" and info["process_count"] == 1
        mesh = make_mesh()
        assert (mesh.size, mesh.device.type, mesh.backend) == (1, "cuda", "nccl")
        scene = load_scene(SCENE0, asset_root=ASSET_ROOT).to(mesh.device)
        cfg = RenderConfig(width=64, height=64, spp=4, max_bounces=8)
        got, st = render_samples_sharded(scene.diffuse, scene, 2, cfg, mesh)
        want, st_w = render_samples(scene.diffuse, scene, 2, cfg, device=mesh.device)
        assert torch.equal(got, want)
        assert int(st.segments) == int(st_w.segments)
        assert int(st.shadow_rays) == int(st_w.shadow_rays)
    finally:
        shutdown_distributed()


@pytest.fixture(scope="module")
def bvh_big():
    """assets.bvh_scene (20,498 triangles, its BVH attached) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from inverse_path_tracer_torch import bvh_scene

    return bvh_scene(torch.device("cuda", 0))


@pytest.mark.parametrize("kind", ["large", "bvh_scene"])
def test_bvh_traversal_kernel_matches_intersect_bvh(card, bvh_big, kind):
    """The traversal kernel (intersect_tile on the route's tables) against
    the plain intersect_bvh on the same rays: t, triangle (internal: the
    leaf order) and the work counts equal; its triangle in global order that
    of B10's clustered sweep or, at an exact tie, a lower global index."""
    from inverse_path_tracer_torch import large_scene
    from inverse_path_tracer_torch.ops.bvh import attach_bvh
    from inverse_path_tracer_torch.ops.kernels.render_kernel import (
        bvh_traversal,
        intersect_tile,
        intersect_tile_plain,
        pack_tables,
    )

    scene = attach_bvh(large_scene(card)) if kind == "large" else bvh_big
    cfg = RenderConfig(width=128, height=64, spp=4, intersect="bvh")
    n = 1 << 14
    g = torch.Generator(device="cpu").manual_seed(11)
    p_box = (torch.rand((n, 3), generator=g) * 3.6 - 1.8 + torch.tensor([0.0, 0.0, 4.0])).to(card)
    d_box = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1).to(card)
    p_cam, d_cam = camera_rays(scene, cfg, 2, torch.arange(n, device=card))
    tabs = pack_tables(scene, scene.diffuse, cfg)
    tabs_c = pack_tables(scene, scene.diffuse, cfg.with_(intersect="auto"))
    assert tabs.nodes is not None and tabs_c.cluster_k > 0
    for p, d in ((p_box, d_box), (p_cam, d_cam)):
        pt, dt = p.T.contiguous(), d.T.contiguous()
        c_k = torch.zeros(3, dtype=torch.int64, device=card)
        c_p = torch.zeros(3, dtype=torch.int64, device=card)
        before = bvh_traversal.launches
        t, i = intersect_tile(scene, cfg, pt, dt, tables=tabs, counts=c_k)
        assert bvh_traversal.launches == before + 1
        t_p, i_p = intersect_tile_plain(scene, cfg, pt, dt, counts=c_p)
        assert torch.equal(t, t_p) and torch.equal(i, i_p) and torch.equal(c_k, c_p)
        t2, i2 = intersect_tile(scene, cfg, pt, dt, tables=tabs)
        assert torch.equal(t, t2) and torch.equal(i, i2)
        t_c, i_c = intersect_tile(scene, cfg.with_(intersect="auto"), pt, dt, tables=tabs_c)
        hit = torch.isfinite(t)
        g_b, g_c = tabs.perm[i.long()], tabs_c.perm[i_c.long()]
        assert torch.equal(t, t_c) and int(hit.sum()) > n // 4
        tie = hit & (g_b != g_c)
        assert bool((g_b[tie] < g_c[tie]).all())


def test_bvh_route_on_the_card(card, bvh_big):
    """The route (B1, B2, B3, B4 on the traversal) against the clustered
    mega route on the 20,498-triangle scene: radiance of at least 97% of
    samples within rtol 1e-4 / atol 1e-5, counts equal, gradients under the
    vertex-normal bound; the route's launches counted, no staged kernel."""
    from inverse_path_tracer_torch import loss_and_grad_range
    from inverse_path_tracer_torch.ops.kernels.render_kernel import bvh_traversal
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import init_tile

    scene = bvh_big
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8)
    w = torch.rand((cfg.n_samples, 3), generator=torch.Generator().manual_seed(6)).to(card)
    out = {}
    for what, c in (("bvh", cfg.with_(intersect="bvh")), ("swept", cfg.with_(wavefront="mega"))):
        b0, s0 = bvh_traversal.launches, init_tile.launches
        m = scene.diffuse.clone().requires_grad_()
        vals, st = render_samples(m, scene, 3, c, device=card)
        (vals * w).sum().backward()
        _, g_lg, _ = loss_and_grad_range(scene.diffuse, scene, 3, c, 0, c.n_samples,
                                         lambda v, lo: (v * w[lo:lo + v.shape[0]]).sum(),
                                         device=card)
        assert (bvh_traversal.launches > b0) is (what == "bvh") and init_tile.launches == s0
        out[what] = (vals.detach(), int(st.segments), int(st.shadow_rays), m.grad, g_lg)
    (vb, sb, hb, gb, lb), (vc, sc, hc, gc, lc) = out["bvh"], out["swept"]
    assert (sb, hb) == (sc, hc)
    assert float(torch.isclose(vb, vc, rtol=RTOL, atol=ATOL).all(dim=1).float().mean()) >= 0.97
    assert_vn_grad_close(gb, gc)
    assert_vn_grad_close(lb, lc)
    torch.testing.assert_close(lb, gb, rtol=1e-5, atol=0)


def test_gradient_kernels_past_2048_triangles(card, bvh_big):
    """B2 (on the route and clustered), B4 on the route's B3 records and B9
    with their accumulators in global memory (20,498 triangles) against
    their plain versions, and bit-equal across two calls, at launches past
    the grid of 2 blocks an SM (131,072 lanes for B2 and B4, whose grid is
    then cut and B4's blocks stride; 65,536 for B9)."""
    from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        stage_reverse_tile,
        stage_reverse_tile_plain,
    )

    scene = bvh_big
    nt = scene.n_tri
    cfg = RenderConfig(width=128, height=128, spp=8, max_bounces=4)
    n = cfg.n_samples
    g = torch.rand((3, n), generator=torch.Generator().manual_seed(2)).to(card)
    route = cfg.with_(intersect="bvh")
    for c in (route, cfg.with_(wavefront="mega")):
        args = tile_args(scene, c, card, "fused")
        tabs = pack_tables(scene, scene.diffuse, c)
        d1 = grad_tile(scene.diffuse, scene, c, g=g, tables=tabs, **args)
        d2 = grad_tile(scene.diffuse, scene, c, g=g, tables=tabs, **args)
        assert torch.equal(d1, d2)
        assert_vn_grad_close(d1, grad_tile_plain(scene.diffuse, scene, c, g=g, **args))
    args = tile_args(scene, route, card, "fused")
    tabs = pack_tables(scene, scene.diffuse, route)
    _, _, rec = render_tile_rec(scene.diffuse, scene, route, tables=tabs, **args)
    d4 = reverse_tile(nt, route, rec, g, tabs.perm)
    assert torch.equal(d4, reverse_tile(nt, route, rec, g, tabs.perm))
    assert_grad_close(d4, reverse_tile_plain(nt, route, rec, g, tabs.perm))
    assert bool((d4 != 0).any())
    rec9, g9, suf9 = b9_fixed_records(card, nt, 1 << 16)
    k = rec9.shape[0] // 16
    dm, so = stage_reverse_tile(nt, cfg, k, rec9, g9, suf9)
    dm2, so2 = stage_reverse_tile(nt, cfg, k, rec9, g9, suf9)
    assert torch.equal(dm, dm2) and torch.equal(so, so2)
    dm_p, so_p = stage_reverse_tile_plain(nt, cfg, k, rec9, g9, suf9)
    assert_grad_close(dm, dm_p)
    torch.testing.assert_close(so, so_p, rtol=1e-6, atol=0)


def test_kernels_without_a_bvh_flavour_refuse_bvh_tables(card, scene0):
    """B5, B6 (both sinks) and B7 have no BVH traversal: on the BVH route's
    tables they raise rather than sweep the leaf-order rows."""
    from inverse_path_tracer_torch.ops.bvh import attach_bvh
    from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
        inverse_tile,
        inverse_tile_global,
        inverse_tile_rec,
    )
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import init_tile

    scene = attach_bvh(scene0)
    cfg = RenderConfig(width=8, height=8, spp=1, max_bounces=2, intersect="bvh")
    args = tile_args(scene, cfg, card, "fused")
    pix = torch.rand((3, cfg.n_samples), generator=torch.Generator().manual_seed(3)).to(card)
    for fn, kw in ((inverse_tile, dict(pix=pix)), (inverse_tile_global, dict(pix=pix)),
                   (inverse_tile_rec, {})):
        with pytest.raises(ValueError, match="BVH route"):
            fn(scene, cfg, **args, **kw)
    with pytest.raises(ValueError, match="BVH route"):
        init_tile(scene.diffuse, scene, cfg, p=args["p"], d=args["d"], alive=args["alive"])

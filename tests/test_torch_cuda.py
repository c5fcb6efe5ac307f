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

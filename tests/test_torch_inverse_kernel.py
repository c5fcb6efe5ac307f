"""The plain versions of the inverse kernels (B5 inverse_tile_plain, B6
inverse_tile_rec_plain) and the records reduction against the JAX package,
on the CPU.

  * B5's plain grid, through grids_from_acc, against the interpreted Pallas
    inverse_tile_pallas through JAX's grids_from_acc, under external
    uniforms and the fused RNG (rng.key_words(13) against
    _pallas_keys(PRNGKey(13))): DIFFUSE channel rtol 1e-4 / atol 1e-5,
    counts equal.
  * B6's plain records against the interpreted inverse_tile_pallas_rec:
    the hit and nee_ok rows equal; dst, src and w where hit, nee_w and e_idx
    where nee_ok, rtol 1e-4 / atol 1e-5.  Pallas leaves stale values in the
    slots after a path ends; the port writes zeros there.
  * B6's global-grid sink (inverse_tile_global, its plain twin on the CPU)
    against the interpreted inverse_tile_pallas, as B5's plain grid is held;
    it adds into the caller's float64 grid in the kernels' order, which
    unperm_grid maps back to B5's global order on a clustered scene.
  * grids_from_edge_records against _grids_from_edge_records on the same
    records (rtol 2e-4 / atol 1e-3, as tests/test_pallas_inverse.py:172)
    and against B5's plain grid; the 2M-record, ~1e13-prefix case of
    tests/test_inverse.py:130 comes back exact.
Sizes stay at 8x8 pixels x 4 spp and 6 bounces, since interpret mode is slow.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.ops.pallas import inverse_kernel as jik
from inverse_path_tracer_tpu.render.forward import _pallas_keys
from inverse_path_tracer_tpu.render.inverse import _grids_from_edge_records

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, scene_from_numpy
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
    grids_from_acc,
    grids_from_edge_records,
    inverse_grid_fits,
    inverse_tile,
    inverse_tile_plain,
    inverse_tile_global,
    inverse_tile_rec,
    inverse_tile_rec_plain,
    unperm_grid,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
N = 8 * 8 * 4
BOUNCES = 6
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def scenes():
    js = jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    return js, scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})


def inputs(seed):
    """Camera-like rays into the box, a few dead lanes, pixel colours."""
    g = np.random.default_rng(seed)
    d = np.stack([g.uniform(-1, 1, N), g.uniform(-1, 1, N), np.ones(N)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    alive = (g.random((1, N)) > 0.05).astype(np.float32)
    pix = g.random((3, N)).astype(np.float32)
    orig = (np.arange(N, dtype=np.int32) * 3 + 1000)[None, :]
    u = g.random((BOUNCES * 8, N)).astype(np.float32)
    return np.zeros((3, N), np.float32), d, alive, pix, orig, u


def run_both(scenes, mode, seed, records):
    js, ts = scenes
    jcfg = jipt.RenderConfig(max_bounces=BOUNCES, fast_recip=False)
    tcfg = RenderConfig(max_bounces=BOUNCES)
    p, d, alive, pix, orig, u = inputs(seed)
    fused = mode == "fused"
    jfn = jik.inverse_tile_pallas_rec if records else jik.inverse_tile_pallas
    want = jfn(js, jcfg, *map(jnp.asarray, (p, d, alive, pix)), None if fused else jnp.asarray(u),
               block=128, interpret=True, orig=jnp.asarray(orig),
               keys=_pallas_keys(jax.random.PRNGKey(13)) if fused else None)
    tfn = inverse_tile_rec_plain if records else inverse_tile_plain
    rays = (p, d, alive) if records else (p, d, alive, pix)
    got, stats = tfn(ts, tcfg, *map(torch.from_numpy, rays),
                     uniforms=None if fused else torch.from_numpy(u), orig=torch.from_numpy(orig),
                     keys=rng.key_words(13) if fused else None)
    return np.array(want), got, stats, pix


@pytest.mark.parametrize("mode", ["external", "fused"])
def test_grid_plain_matches_pallas_interpret(scenes, mode):
    js, ts = scenes
    want_acc, got_acc, stats, _ = run_both(scenes, mode, seed=1, records=False)
    want = jik.grids_from_acc(jnp.asarray(want_acc), ts.n_tri)
    got = grids_from_acc(got_acc)
    assert got_acc.shape == (ts.n_tri + 1, ts.n_tri, 9) and got_acc.dtype == torch.float32
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.w_sum.numpy(), np.asarray(want.w_sum), rtol=RTOL, atol=ATOL)
    for name in ("pixel_sum", "light_sum", "factors_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert float(got.count.sum()) > N and float(stats[0].sum()) > N


@pytest.mark.parametrize("mode", ["external", "fused"])
def test_global_sink_plain_matches_pallas_interpret(scenes, mode):
    """inverse_tile_global on the CPU against the interpreted B5 Pallas
    kernel (_kernel_inv's grid) on the same rays."""
    js, ts = scenes
    want_acc, _, stats_b5, pix = run_both(scenes, mode, seed=5, records=False)
    p, d, alive, _, orig, u = inputs(5)
    fused = mode == "fused"
    acc, stats = inverse_tile_global(ts, RenderConfig(max_bounces=BOUNCES),
                                     *map(torch.from_numpy, (p, d, alive, pix)),
                                     uniforms=None if fused else torch.from_numpy(u),
                                     orig=torch.from_numpy(orig),
                                     keys=rng.key_words(13) if fused else None)
    assert acc.dtype == torch.float64 and acc.shape == (ts.n_tri + 1, ts.n_tri, 9)
    want = jik.grids_from_acc(jnp.asarray(want_acc), ts.n_tri)
    got = grids_from_acc(acc)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    for name in ("w_sum", "pixel_sum", "light_sum", "factors_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert torch.equal(stats, stats_b5)


def test_global_sink_adds_in_kernel_order(scenes, monkeypatch):
    """The global sink adds into the caller's grid in the kernels' internal
    order (clusters of 8 on scene 0); unperm_grid gives B5's global grid."""
    from inverse_path_tracer_torch.ops.kernels import clusters

    _, ts = scenes
    monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 8)
    cfg = RenderConfig(max_bounces=BOUNCES, cluster_k=8)
    perm = clusters.kernel_perm(ts, cfg)
    assert perm is not None and not torch.equal(perm, torch.arange(ts.n_tri))
    p, d, alive, pix, orig, u = map(torch.from_numpy, inputs(6))
    args = dict(p=p, d=d, alive=alive, pix=pix, uniforms=u, orig=orig)
    before = inverse_tile_global.launches
    once, stats = inverse_tile_global(ts, cfg, **args)
    acc = torch.zeros_like(once)
    for _ in range(2):
        out, _ = inverse_tile_global(ts, cfg, acc=acc, **args)
        assert out is acc
    assert inverse_tile_global.launches == before  # the CPU runs the plain twin
    torch.testing.assert_close(acc, 2 * once, rtol=1e-12, atol=0)
    grid, stats_b5 = inverse_tile_plain(ts, cfg, **args)
    torch.testing.assert_close(unperm_grid(once, perm).float(), grid, rtol=1e-6, atol=1e-6)
    assert torch.equal(stats, stats_b5)
    with pytest.raises(ValueError, match="acc"):
        inverse_tile_global(ts, cfg, acc=acc.float(), **args)


@pytest.mark.parametrize("mode", ["external", "fused"])
def test_records_plain_match_pallas_interpret(scenes, mode):
    want, got, stats, _ = run_both(scenes, mode, seed=2, records=True)
    w = want.reshape(BOUNCES, 8, N)
    g = got.numpy().reshape(BOUNCES, 8, N)
    np.testing.assert_array_equal(g[:, 2], w[:, 2])  # hit
    np.testing.assert_array_equal(g[:, 4], w[:, 4])  # nee_ok
    hit, ok = w[:, 2] > 0, w[:, 4] > 0
    for row, mask in ((0, hit), (1, hit), (3, hit), (5, ok), (6, ok)):
        np.testing.assert_allclose(g[:, row][mask], w[:, row][mask], rtol=RTOL, atol=ATOL,
                                   err_msg=f"row {row}")
    assert hit.sum() > N and ok.sum() > 0
    # Slots past a ray's last bounce are zero; the counts match the slots.
    reached = stats[0].numpy().astype(int)
    for b in range(BOUNCES):
        assert not g[b][:, reached <= b].any()
    assert int(stats[1].sum()) == int(hit.sum())


def test_reduction_matches_jax_and_the_grid(scenes):
    js, ts = scenes
    want_rec, got_rec, _, pix = run_both(scenes, "external", seed=3, records=True)
    cfg = RenderConfig(max_bounces=BOUNCES)
    jcfg = jipt.RenderConfig(max_bounces=BOUNCES)
    want = np.array(_grids_from_edge_records(jnp.asarray(want_rec), jnp.asarray(pix.T), js,
                                              jcfg, None))
    got = grids_from_edge_records(torch.from_numpy(want_rec), torch.from_numpy(pix.T), ts, cfg)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy().reshape(-1, 9), want, rtol=2e-4, atol=1e-3)
    # The port's own records reduce to B5's plain grid on the same rays.
    p, d, alive, pix2, orig, u = inputs(3)
    grid, _ = inverse_tile_plain(ts, cfg, *map(torch.from_numpy, (p, d, alive, pix2)),
                                 uniforms=torch.from_numpy(u), orig=torch.from_numpy(orig))
    from_rec = grids_from_edge_records(got_rec, torch.from_numpy(pix2.T), ts, cfg)
    torch.testing.assert_close(from_rec.float(), grid, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(from_rec.float(), torch.from_numpy(want.reshape(grid.shape)),
                               rtol=2e-4, atol=1e-3)


def test_reduction_exact_beside_huge_totals(scenes):
    """tests/test_inverse.py:130: ~2M edge records of weight ~1e7 (a ~1e13
    total) with 64 tiny weights in an early bin.  The float64 index_add_
    has no prefix differences, so the tiny bin comes back exact."""
    _, ts = scenes
    g = np.random.default_rng(7)
    b, tile = 16, 65536
    nt = ts.n_tri
    dst = g.integers(5, nt + 1, size=(b, tile)).astype(np.float32)
    src = g.integers(0, nt, size=(b, tile)).astype(np.float32)
    w = g.uniform(0.5e7, 1e7, size=(b, tile)).astype(np.float32)
    tiny = np.arange(64)
    dst[0, tiny], src[0, tiny] = 0.0, 1.0
    w[0, tiny] = g.uniform(1e-3, 2e-3, size=64).astype(np.float32)
    rec = np.zeros((b, 8, tile), np.float32)
    rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3] = dst, src, 1.0, w
    rec[:, 5] = np.nan  # nee_w of lanes whose nee_ok is 0: masked, not multiplied
    grid = grids_from_edge_records(torch.from_numpy(rec.reshape(b * 8, tile)),
                                   torch.zeros(tile, 3), ts, RenderConfig(max_bounces=b))
    flat = grid.reshape(-1, 9).numpy()
    assert not np.isnan(flat).any()
    expect = float(np.sum(w[0, tiny].astype(np.float64)))
    assert abs(flat[1, 0] - expect) <= 1e-12 * expect
    assert flat[1, 8] == 64.0
    keys = (dst * nt + src).astype(np.int64)
    for bin_ in (int(keys[1, 0]), int(keys[7, 3])):
        np.testing.assert_allclose(flat[bin_, 0], np.sum(w.astype(np.float64)[keys == bin_]),
                                   rtol=1e-12)
    assert flat[:, 8].sum() == b * tile


def test_wrappers_on_cpu_run_the_plain_versions(scenes):
    _, ts = scenes
    cfg = RenderConfig(max_bounces=BOUNCES)
    p, d, alive, pix, orig, u = map(torch.from_numpy, inputs(4))
    before = (inverse_tile.launches, inverse_tile_rec.launches)
    a = inverse_tile(ts, cfg, p, d, alive, pix, uniforms=u, orig=orig)
    b = inverse_tile_plain(ts, cfg, p, d, alive, pix, uniforms=u, orig=orig)
    c = inverse_tile_rec(ts, cfg, p, d, alive, uniforms=u, orig=orig)
    e = inverse_tile_rec_plain(ts, cfg, p, d, alive, uniforms=u, orig=orig)
    assert (inverse_tile.launches, inverse_tile_rec.launches) == before
    assert all(torch.equal(x, y) for x, y in zip(a + c, b + e))
    with pytest.raises(ValueError, match="p_spec"):
        inverse_tile(ts, cfg.with_(p_spec=0.1), p, d, alive, pix, uniforms=u, orig=orig)
    with pytest.raises(ValueError, match="pix"):
        inverse_tile(ts, cfg, p, d, alive, pix[:2], uniforms=u, orig=orig)
    with pytest.raises(ValueError, match="exactly one"):
        inverse_tile_rec(ts, cfg, p, d, alive, uniforms=u, orig=orig, keys=(0, 1))


@pytest.mark.parametrize("n_tri,vn,fits", [(30, False, True), (78, False, True),
                                           (79, False, False), (242, True, False)])
def test_grid_kernel_size_limit(n_tri, vn, fits):
    """B5 holds (nT+1)*nT*9 floats plus the tables in 227 KB of shared memory."""
    fake = types.SimpleNamespace(n_tri=n_tri, n_emissive=2, has_vertex_normals=vn)
    assert inverse_grid_fits(fake) is fits

"""The staged wavefront (kernels B7, B8, B9) on the CPU, against the JAX
package's interpreted Pallas kernels (fast_recip=False) and against the
port's own mega path.

  * Plain B7, B8 (start bounce 0 and 4, the second stage partial; records;
    external uniforms and the fused RNG) and B9 against init_tile_pallas,
    stage_tile_pallas and stage_reverse_tile_pallas on scene 0 clustered
    (CLUSTER_MIN_TP set to 8 in both packages, cluster_k 8: 4 clusters, a
    real permutation).  Carries and records rtol 1e-4 / atol 1e-5 with hit,
    esc and tri rows equal; a lane that dies keeps its state in the port and
    holds junk in the Pallas carry, so point/hit/idx are compared where
    both keep the lane alive; B9 rtol 1e-5 (B4's tolerance).
  * The stage orders equal JAX's and are stable partitions.
  * The re-sort kernel's algorithm (reorder.cu), mirrored in numpy: tile
    histograms, their bucket-major, tile-minor exclusive prefix (by rows,
    then the totals before each bucket) and the stable rank of each lane in
    its warp's steps give torch.sort(key, stable=True) and the live count,
    for ragged lane counts, tiles of 32, 1024 and 2048 lanes, 2, 128 and
    432 buckets, all, no and every other lane dead; reorder_tile on CPU
    tensors returns the parent's chain (the sort, the gathers, the live
    count) bit for bit and refuses wrong dtypes and shapes.
  * Staged equals mega bit for bit, counts equal, on the flat large scene
    and scene 0 clustered, in both RNG modes; on the vertex-normal large
    scene at least 97% of lanes bit-equal (JAX's knife-edge bound).
  * The staged render and its autograd gradient against JAX's staged
    Pallas path and against jax.grad of the XLA path (grad_mode="ad") on
    JAX's rays and uniforms: radiance rtol 1e-4 / atol 1e-5, counts equal,
    gradients rtol 2e-4 / atol 1e-7.
  * loss_and_grad_range staged equals autograd's gradient (rtol 1e-6).
  * The clustered extraction: plain B6 records against
    inverse_tile_pallas_rec (internal indices), the reduction with perm
    against JAX's, and the records route on the large scene against the
    plain wavefront path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.ops.pallas import inverse_kernel as jik
from inverse_path_tracer_tpu.ops.pallas import render_kernel as jrk
from inverse_path_tracer_tpu.render import forward as jfwd
from inverse_path_tracer_tpu.render.inverse import _grids_from_edge_records

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import (
    ASSET_ROOT,
    RenderConfig,
    loss_and_grad_range,
    render_samples,
    trace_transport_range,
)
from inverse_path_tracer_torch.assets import large_scene
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels import clusters
from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
    grids_from_edge_records,
    inverse_tile_rec_plain,
)
from inverse_path_tracer_torch.ops.kernels.render_kernel import CARRY_ROWS
from inverse_path_tracer_torch.ops.kernels.reorder_kernel import (
    _bin_keys,
    reorder_tile,
    reorder_tile_plain,
)
from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
    init_tile,
    init_tile_plain,
    stage_reverse_tile,
    stage_reverse_tile_plain,
    stage_tile,
    stage_tile_plain,
)
from inverse_path_tracer_torch.render import forward as tfwd
from test_torch_cluster import small_clusters, to_port  # noqa: F401 (fixture)
from test_torch_forward import SCENE0, jax_rays_and_uniforms

CPU = dict(device="cpu")
N = 8 * 8 * 4
K, BOUNCES = 4, 6  # the second stage is partial (bounces 4, 5)
BLOCK = 128
RTOL, ATOL = 1e-4, 1e-5


def scene0():
    js = jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    return js, to_port(js)


def rays(seed):
    """Camera-like rays into the box, a few dead lanes."""
    g = np.random.default_rng(seed)
    d = np.stack([g.uniform(-1, 1, N), g.uniform(-1, 1, N), np.ones(N)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    alive = (g.random((1, N)) > 0.05).astype(np.float32)
    orig = (np.arange(N, dtype=np.int32) * 3 + 1000)[None, :]
    u = g.random((2 * K * 8, N)).astype(np.float32)
    return np.zeros((3, N), np.float32), d, alive, orig, u


def assert_carry_close(got, want):
    """Carries: every lane's d, l_e, l_d, pm, radiance and counts; where
    both keep the lane alive, its pending hit too.  A lane may only be
    alive in the port past the global bounce budget (the Pallas stage runs
    those bounces masked and clears alive)."""
    got, want = got.numpy(), np.asarray(want)
    for rows in (slice(0, 3), slice(8, 17), slice(18, 21)):
        np.testing.assert_allclose(got[rows], want[rows], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[21:23], want[21:23])
    differ = got[17] != want[17]
    assert not (differ & (got[17] == 0)).any()
    both = (got[17] > 0) & ~differ
    np.testing.assert_array_equal(got[6:8, both], want[6:8, both])
    np.testing.assert_allclose(got[3:6, both], want[3:6, both], rtol=RTOL, atol=ATOL)
    return differ.sum()


def assert_records_close(got, want, slots):
    w = np.asarray(want).reshape(slots, 16, -1)
    live = (w[:, 14] + w[:, 15]) > 0  # the bounce ran
    w = np.where(live[:, None, :], w, 0.0)  # Pallas leaves stale values after a path
    g = got.numpy().reshape(slots, 16, -1)
    np.testing.assert_array_equal(g[:, 13:16], w[:, 13:16])
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    return live


@pytest.mark.parametrize("mode", ["external", "fused"])
def test_stage_kernels_plain_match_pallas(small_clusters, mode):  # noqa: F811
    js, ts = scene0()
    jcfg = jipt.RenderConfig(max_bounces=BOUNCES, stage_bounces=K, cluster_k=8,
                             fast_recip=False)
    tcfg = RenderConfig(max_bounces=BOUNCES, stage_bounces=K, cluster_k=8)
    p, d, alive, orig, u = rays(seed=len(mode))
    fused = mode == "fused"
    jkeys = jfwd._pallas_keys(jax.random.PRNGKey(13)) if fused else None
    tkeys = rng.key_words(13) if fused else None

    # B7.
    j_carry = jrk.init_tile_pallas(js.diffuse, js, jcfg, *map(jnp.asarray, (p, d, alive)),
                                   block=BLOCK, interpret=True)
    carry = init_tile_plain(ts.diffuse, ts, tcfg, *map(torch.from_numpy, (p, d, alive)))
    assert carry.shape == (CARRY_ROWS, N)
    live = alive[0] > 0
    jc = np.asarray(j_carry)
    np.testing.assert_array_equal(carry.numpy()[:, live], jc[:, live])
    assert carry[6].sum() > N / 2 and not carry[3:8, ~live].any()

    # B8 from start 0 (whole stage) and 4 (partial), on JAX's carries.
    c_in = j_carry
    for s in range(2):
        u_s = u[s * K * 8 : (s + 1) * K * 8]
        j_out, j_rec = jrk.stage_tile_pallas(
            js.diffuse, js, jcfg, c_in, jnp.asarray(orig), s * K, K,
            uniforms=None if fused else jnp.asarray(u_s), block=BLOCK, interpret=True,
            keys=jkeys, with_rec=True)
        t_in = torch.from_numpy(np.array(c_in))
        targs = (ts.diffuse, ts, tcfg, t_in, torch.from_numpy(orig), s * K, K,
                 None if fused else torch.from_numpy(u_s), tkeys)
        out, rec = stage_tile_plain(*targs, with_rec=True)
        past_budget = assert_carry_close(out, j_out)
        assert (past_budget > 0) == (s == 1)
        ran = assert_records_close(rec, j_rec, K)
        assert ran.sum() > (N if s == 0 else 10)
        # Without records, and through the wrapper on CPU tensors: the same
        # carry, and no launch.
        before = stage_tile.launches
        assert torch.equal(stage_tile(*targs), out) and stage_tile.launches == before

        # B9 on the stage's Pallas records, from a random carry.
        g = np.random.default_rng(s).random((3, N)).astype(np.float32)
        suf = np.random.default_rng(s + 5).random((4, N)).astype(np.float32)
        suf[3] = (suf[3] > 0.7).astype(np.float32)
        j_dm, j_suf = jrk.stage_reverse_tile_pallas(ts.n_tri, jcfg, K, j_rec, jnp.asarray(g),
                                                    jnp.asarray(suf), block=BLOCK,
                                                    interpret=True)
        rec_j = torch.from_numpy(np.array(j_rec))
        dm, suf_out = stage_reverse_tile_plain(ts.n_tri, tcfg, K, rec_j, torch.from_numpy(g),
                                               torch.from_numpy(suf))
        np.testing.assert_allclose(dm.numpy(), np.asarray(j_dm), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(suf_out.numpy(), np.asarray(j_suf), rtol=1e-5, atol=1e-9)
        assert np.count_nonzero(np.asarray(j_dm)) > 10
        before = stage_reverse_tile.launches
        again = stage_reverse_tile(ts.n_tri, tcfg, K, rec_j, torch.from_numpy(g),
                                   torch.from_numpy(suf))
        assert stage_reverse_tile.launches == before and torch.equal(again[0], dm)
        c_in = j_out
    before = init_tile.launches
    assert torch.equal(init_tile(ts.diffuse, ts, tcfg, *map(torch.from_numpy, (p, d, alive))),
                       carry)
    assert init_tile.launches == before


def test_stage_orders_match_jax():
    n = 257
    g = np.random.default_rng(0)
    lo = np.full(3, -1.0, np.float32)
    inv_ext = np.full(3, 0.5, np.float32)
    for alive in (np.zeros(n), np.ones(n), (np.arange(n) % 3 == 0).astype(np.float32),
                  g.integers(0, 2, n).astype(np.float32)):
        carry = g.normal(size=(CARRY_ROWS, n)).astype(np.float32)
        carry[17] = alive
        tc = torch.from_numpy(carry)
        orders = [(tfwd._alive_first_order(tc[17]), jfwd._alive_first_order(jnp.asarray(alive)))]
        for cells in (2, 4):
            orders.append((tfwd._binned_order(tc, torch.from_numpy(lo), torch.from_numpy(inv_ext),
                                              cells),
                           jfwd._binned_order(jnp.asarray(carry), jnp.asarray(lo),
                                              jnp.asarray(inv_ext), cells)))
        for got, want in orders:
            o = got.numpy()
            np.testing.assert_array_equal(o, np.asarray(want))
            assert sorted(o.tolist()) == list(range(n))
            first_dead = np.argmax(alive[o] <= 0) if (alive <= 0).any() else n
            assert (alive[o][:first_dead] > 0).all() and (alive[o][first_dead:] <= 0).all()
        o = orders[0][0].numpy()
        alive_idx = [j for j in o if alive[j] > 0]
        assert alive_idx == sorted(alive_idx)  # stable


def counting_sort_mirror(key, buckets, live_buckets, threads, items):
    """reorder.cu's three kernels in numpy, tile by tile and warp step by
    warp step: (order, live), new column j holding old column order[j]."""
    n, tile, warps = len(key), threads * items, threads // 32
    blocks = -(-n // tile)
    chunk = lambda a, b: key[min(a, n) : min(b, n)]
    # key_kernel: each tile's histogram, column `block` of the table.
    table = np.stack([np.bincount(chunk(t * tile, (t + 1) * tile), minlength=buckets)
                      for t in range(blocks)], axis=1)
    # scan_kernel: each bucket's row to its exclusive prefix over the tiles,
    # and its total; with the totals of the buckets before it (rank_kernel),
    # the exclusive prefix of the table in bucket-major, tile-minor order.
    totals = table.sum(axis=1)
    first_column = np.cumsum(totals) - totals
    prefix = first_column[:, None] + np.cumsum(table, axis=1) - table
    flat = table.reshape(-1)
    np.testing.assert_array_equal(prefix.reshape(-1), np.cumsum(flat) - flat)
    live = int(first_column[live_buckets])
    # rank_kernel: warp w holds lanes [tile0 + w*32*items, + 32*items); a
    # lane's position in its tile's bucket order, then its new column.
    order = np.full(n, -1, np.int64)
    for t in range(blocks):
        w0 = [t * tile + w * 32 * items for w in range(warps)]
        counts = np.stack([np.bincount(chunk(a, a + 32 * items), minlength=buckets)
                           for a in w0])
        tile_counts = counts.sum(axis=0)
        local = np.cumsum(tile_counts) - tile_counts
        base = local[None, :] + np.cumsum(counts, axis=0) - counts
        delta = prefix[:, t] - local
        for w, a in enumerate(w0):
            for it in range(items):
                step = chunk(a + 32 * it, a + 32 * (it + 1))
                for lane, b in enumerate(step):
                    pos = base[w, b] + np.count_nonzero(step[:lane] == b)
                    order[pos + delta[b]] = a + 32 * it + lane
                base[w] += np.bincount(step, minlength=buckets)
    return order, live


def reorder_carry(n, dead, seed):
    """A carry of n lanes with directions of every octant, points in and
    around the box [-1, 1]^3 (lo -1, inv_ext 0.5), and the dead pattern."""
    g = np.random.default_rng(seed)
    carry = g.normal(size=(CARRY_ROWS, n)).astype(np.float32)
    carry[3:6] = g.uniform(-1.5, 1.5, size=(3, n)).astype(np.float32)
    carry[17] = {"all": np.zeros(n), "none": np.ones(n),
                 "alternate": np.arange(n) % 2}[dead].astype(np.float32)
    orig = g.permutation(n).astype(np.int32)[None, :]
    bins = (torch.full((3,), -1.0), torch.full((3,), 0.5))
    return torch.from_numpy(carry), torch.from_numpy(orig), bins


@pytest.mark.parametrize("dead", ["all", "none", "alternate"])
@pytest.mark.parametrize("cells", [None, 2, 3])  # 2, 128 and 432 buckets
@pytest.mark.parametrize("threads,items", [(32, 1), (256, 4), (256, 8)])
def test_counting_sort_mirror_equals_stable_sort(threads, items, cells, dead):
    tile = threads * items
    n = 2 * tile + 45  # ragged: the last tile holds 45 lanes
    carry, orig, bins = reorder_carry(n, dead, seed=tile + (cells or 0))
    if cells is None:
        key, buckets, live_buckets = (carry[17] <= 0).to(torch.int64), 2, 1
    else:
        key = _bin_keys(carry, *bins, cells)
        buckets, live_buckets = 16 * cells**3, 8 * cells**3
    assert int(key.min()) >= 0 and int(key.max()) < buckets
    order, live = counting_sort_mirror(key.numpy(), buckets, live_buckets, threads, items)
    want = torch.sort(key, stable=True).indices
    np.testing.assert_array_equal(order, want.numpy())
    assert live == int((carry[17] > 0).sum()) == {"all": 0, "none": n, "alternate": n // 2}[dead]
    got = reorder_tile_plain(carry, orig, None if cells is None else bins, cells or 1, True)
    assert torch.equal(got[0], carry[:, torch.from_numpy(order)])
    assert torch.equal(got[1], orig[:, torch.from_numpy(order)])
    assert int(got[2]) == live and torch.equal(got[3], want)


def parent_reorder(carry, orig, bins, cells):
    """The parent's re-sort between stages, as render/forward.py ran it."""
    order = (tfwd._binned_order(carry, *bins, cells) if bins is not None
             else tfwd._alive_first_order(carry[17]))
    carry, orig = carry[:, order].contiguous(), orig[:, order].contiguous()
    return carry, orig, (carry[17] > 0).sum(dtype=torch.int32).reshape(1), order


@pytest.mark.parametrize("with_rec", [False, True])
@pytest.mark.parametrize("cells", [None, 1, 2, 3])
def test_reorder_tile_on_cpu_is_the_parent_chain(cells, with_rec):
    carry, orig, bins = reorder_carry(777, "alternate", seed=cells or 0)
    carry[17, 300:] = 1.0
    b = None if cells is None else bins
    got = reorder_tile(carry, orig, b, cells or 2, with_rec)
    want = parent_reorder(carry, orig, b, cells or 2)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[3], want[3]) if with_rec else got[3] is None


def test_reorder_tile_refuses_bad_inputs():
    carry, orig, bins = reorder_carry(64, "none", seed=1)
    bad = [((carry.double(), orig, bins, 2), "carry"), ((carry[:23], orig, bins, 2), "carry"),
           ((carry, orig.long(), bins, 2), "orig"), ((carry, orig[:, :63], bins, 2), "orig"),
           ((carry, orig, (bins[0][:2], bins[1]), 2), "lo"),
           ((carry, orig, (bins[0], bins[1].double()), 2), "inv_ext"),
           ((carry, orig, bins, 0), "cells"), ((carry[:, ::2], orig[:, :32], bins, 2), "contig")]
    for args, what in bad:
        with pytest.raises(ValueError, match=what):
            reorder_tile(*args)


def external_inputs(count, bounces, seed):
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((count, 3), generator=g) * torch.tensor([0.5, 0.5, 0.1]) + torch.tensor(
        [0.0, 0.0, 1.0])
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    return (torch.zeros_like(d), d), torch.rand((bounces * 8, count), generator=g)


@pytest.mark.parametrize("mode", ["external", "fused"])
def test_staged_equals_mega_bitwise(mode):
    scene = large_scene(vertex_normals=False)
    cfg = RenderConfig(width=6, height=6, spp=2, max_bounces=6, tile_size=40,
                       rng="external" if mode == "external" else "fused")
    assert tfwd._use_staged(cfg, scene)
    kw = dict(CPU)
    if mode == "external":
        kw["rays"], kw["uniforms"] = external_inputs(cfg.n_samples, cfg.max_bounces, 3)
    a, sa = render_samples(scene.diffuse, scene, 5, cfg.with_(wavefront="mega"), **kw)
    b, sb = render_samples(scene.diffuse, scene, 5, cfg, **kw)
    assert torch.equal(a, b) and a.abs().sum() > 0
    assert int(sa.segments) == int(sb.segments) > cfg.n_samples
    assert int(sa.shadow_rays) == int(sb.shadow_rays)


def test_staged_vertex_normal_scene_and_gradient_equal_mega():
    scene = large_scene(vertex_normals=True)
    cfg = RenderConfig(width=6, height=6, spp=2, max_bounces=6, tile_size=50)
    grads, vals = {}, {}
    for wf in ("mega", "staged"):
        m = scene.diffuse.clone().requires_grad_()
        vals[wf], _ = render_samples(m, scene, 8, cfg.with_(wavefront=wf), **CPU)
        (vals[wf] ** 2).mean().backward()
        grads[wf] = m.grad
    eq = (vals["mega"] == vals["staged"]).all(dim=1).float().mean()
    assert eq >= 0.97
    torch.testing.assert_close(grads["staged"], grads["mega"], rtol=1e-6, atol=1e-9)
    assert int((grads["mega"] != 0).any(dim=1).sum()) > 20


def test_staged_render_and_gradient_match_jax(small_clusters):  # noqa: F811
    js, ts = scene0()
    shape = dict(width=8, height=4, spp=4, max_bounces=BOUNCES, stage_bounces=K, cluster_k=8)
    jcfg = jipt.RenderConfig(tile_size=128, backend="pallas", rng="external",
                             wavefront="staged", fast_recip=False, **shape)
    key = jax.random.PRNGKey(23)
    w = np.random.default_rng(4).random((jcfg.n_samples, 3)).astype(np.float32)

    def jloss(m, c):
        vals, _ = jfwd.render_samples(m, js, key, c)
        return jnp.sum(vals * w)

    want, want_st = jfwd.render_samples(js.diffuse, js, key, jcfg)
    p, d, u = jax_rays_and_uniforms(js, jcfg, key)
    tcfg = RenderConfig(tile_size=50, rng="external", **shape)
    assert tfwd._use_staged(tcfg, ts)
    m = ts.diffuse.clone().requires_grad_()
    got, got_st = render_samples(m, ts, 0, tcfg, rays=(p, d), uniforms=u, **CPU)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert int(got_st.segments) == int(want_st.segments)
    assert int(got_st.shadow_rays) == int(want_st.shadow_rays)
    (got * torch.from_numpy(w)).sum().backward()
    g_pallas = np.asarray(jax.grad(jloss)(js.diffuse, jcfg))
    g_ad = np.asarray(jax.grad(jloss)(js.diffuse, jcfg.with_(backend="xla", grad_mode="ad")))
    np.testing.assert_allclose(m.grad.numpy(), g_pallas, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(m.grad.numpy(), g_ad, rtol=2e-4, atol=1e-7)
    assert np.count_nonzero(g_ad) > 30

    # loss_and_grad_range, staged, equals the autograd gradient.
    def tile_post(vals, lo):
        return (vals * torch.from_numpy(w[lo : lo + vals.shape[0]])).sum()

    loss, d_mats, stats = loss_and_grad_range(ts.diffuse, ts, 0, tcfg.with_(tile_size=64), 0,
                                              tcfg.n_samples, tile_post, rays=(p, d),
                                              uniforms=u, **CPU)
    torch.testing.assert_close(d_mats, m.grad, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(loss, (got.detach() * torch.from_numpy(w)).sum(), rtol=1e-6,
                               atol=0)
    assert int(stats.segments) == int(got_st.segments)


def test_large_scene_staged_render_matches_jax(tmp_path):
    from test_torch_cluster import jax_large_scene

    js = jax_large_scene(tmp_path, vertex_normals=False)
    ts = large_scene(vertex_normals=False)
    # JAX's auto width (768) on both sides.
    shape = dict(width=4, height=4, spp=2, max_bounces=4, cluster_k=768)
    jcfg = jipt.RenderConfig(tile_size=32, backend="pallas", rng="external", fast_recip=False,
                             **shape)
    assert jfwd._use_staged(jcfg, js)
    assert jrk.cluster_k_for(js.n_tri, jcfg.with_(cluster_k=0)) == 768
    key = jax.random.PRNGKey(2)
    want, want_st = jfwd.render_samples(js.diffuse, js, key, jcfg)
    p, d, u = jax_rays_and_uniforms(js, jcfg, key)
    got, got_st = render_samples(ts.diffuse, ts, 0, RenderConfig(rng="external", **shape),
                                 rays=(p, d), uniforms=u, **CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert int(got_st.segments) == int(want_st.segments)


def test_clustered_extraction_matches_jax(small_clusters):  # noqa: F811
    js, ts = scene0()
    jcfg = jipt.RenderConfig(max_bounces=BOUNCES, cluster_k=8, fast_recip=False)
    tcfg = RenderConfig(max_bounces=BOUNCES, cluster_k=8)
    p, d, alive, orig, _ = rays(seed=7)
    u = np.random.default_rng(8).random((BOUNCES * 8, N)).astype(np.float32)
    pix = np.random.default_rng(9).random((N, 3)).astype(np.float32)
    want = np.array(jik.inverse_tile_pallas_rec(js, jcfg, *map(jnp.asarray, (p, d, alive, pix.T)),
                                                jnp.asarray(u), block=BLOCK, interpret=True,
                                                orig=jnp.asarray(orig)))
    got, _ = inverse_tile_rec_plain(ts, tcfg, *map(torch.from_numpy, (p, d, alive)),
                                    uniforms=torch.from_numpy(u), orig=torch.from_numpy(orig))
    w = want.reshape(BOUNCES, 8, N)
    g = got.numpy().reshape(BOUNCES, 8, N)
    np.testing.assert_array_equal(g[:, 2], w[:, 2])
    np.testing.assert_array_equal(g[:, 4], w[:, 4])
    hit, ok = w[:, 2] > 0, w[:, 4] > 0
    for row, mask in ((0, hit), (1, hit), (3, hit), (5, ok), (6, ok)):
        np.testing.assert_allclose(g[:, row][mask], w[:, row][mask], rtol=RTOL, atol=ATOL)
    perm = clusters.kernel_perm(ts, tcfg)
    j_grid = np.array(_grids_from_edge_records(jnp.asarray(want), jnp.asarray(pix), js, jcfg,
                                               jrk.kernel_perm(js, jcfg)))
    t_grid = grids_from_edge_records(torch.from_numpy(want), torch.from_numpy(pix), ts, tcfg,
                                     perm)
    np.testing.assert_allclose(t_grid.numpy().reshape(-1, 9), j_grid, rtol=2e-4, atol=1e-3)
    # Unmapped, the internal records land in other bins.
    raw = grids_from_edge_records(torch.from_numpy(want), torch.from_numpy(pix), ts, tcfg)
    assert not torch.allclose(raw, t_grid)


def test_large_scene_extraction_records_route_matches_the_wavefront_path():
    scene = large_scene(vertex_normals=False)
    cfg = RenderConfig(width=6, height=6, spp=2, max_bounces=5, tile_size=40)
    img = torch.rand((6, 6, 3), generator=torch.Generator().manual_seed(3))
    auto, st = trace_transport_range(scene, img, 4, cfg, 0, cfg.n_samples, **CPU)
    plain, pst = trace_transport_range(scene, img, 4, cfg.with_(backend="plain"), 0,
                                       cfg.n_samples, **CPU)
    assert torch.equal(auto.count, plain.count) and float(auto.count.sum()) > cfg.n_samples
    assert [int(x) for x in st] == [int(x) for x in pst]
    torch.testing.assert_close(auto.w_sum, plain.w_sum, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(auto.pixel_sum[:, 0], plain.pixel_sum[:, 0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(auto.light_sum[:, 0], plain.light_sum[:, 0], rtol=1e-4, atol=1e-5)


def test_use_staged_policy():
    _, ts = scene0()
    big = large_scene(vertex_normals=False)
    cfg = RenderConfig()
    assert not tfwd._use_staged(cfg, ts) and tfwd._use_staged(cfg, big)
    assert tfwd._use_staged(cfg.with_(wavefront="staged"), ts)
    assert not tfwd._use_staged(cfg.with_(wavefront="mega"), big)
    assert tfwd._stage_plan(cfg) == (4, 4) and tfwd._stage_plan(cfg.with_(max_bounces=6)) == (4, 2)
    assert tfwd._stage_plan(cfg.with_(max_bounces=3)) == (3, 1)
    with pytest.raises(ValueError, match="wavefront"):
        RenderConfig(wavefront="msga")
    with pytest.raises(ValueError, match="stage_bounces"):
        RenderConfig(stage_bounces=0)

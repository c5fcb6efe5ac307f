"""The primary rays made in the kernels (camera mode) on the CPU: the plain
camera_rays against an independent float32 transcription of the kernel's
operation order (render_common.cuh camera_ray), bit for bit; the camera
mode of every wrapper against the same wrapper fed camera_rays' rays, bit
for bit on the plain versions; the fused paths, which pass a Camera and no
ray tensor per launch; and the CPU routes, which leave the launch counters
alone.  No JAX is needed (tests/test_torch_forward.py holds
camera_rays_from_jitter against JAX's camera_rays at rtol 1e-6).
"""

import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import (
    ASSET_ROOT,
    RenderConfig,
    grad_range,
    large_scene,
    load_scene,
    render_range,
    trace_transport_range,
)
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.camera import Camera, camera_inputs, camera_rays
from inverse_path_tracer_torch.ops.kernels import inverse_kernel as ik
from inverse_path_tracer_torch.ops.kernels import render_kernel as rk
from inverse_path_tracer_torch.ops.kernels import staged_kernel as sk
from inverse_path_tracer_torch.render import forward, inverse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
M1, M2, GOLDEN = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9


@pytest.fixture(scope="module")
def scene0():
    return load_scene(os.path.join(REPO, "scenes", "0.txt"), asset_root=ASSET_ROOT)


def np_fmix32(x):
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(M1)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(M2)) & np.uint64(0xFFFFFFFF)
    return x ^ (x >> np.uint64(16))


def np_camera_ray(m33, width, height, spp, key, g):
    """render_common.cuh camera_ray in numpy float32, operation by operation
    (every step rounds once, as the kernel does under -fmad=false)."""
    f = np.float32
    k0, k1 = np.uint64(key >> 32), np.uint64(key & 0xFFFFFFFF)
    g = np.asarray(g, dtype=np.int64)
    r = g // (spp * width)
    c = (g // spp) % width
    h = np_fmix32((g.astype(np.uint64) & np.uint64(0xFFFFFFFF)) ^ k0)

    def unit(slot):
        bits = np_fmix32(((h + np.uint64(slot * GOLDEN)) & np.uint64(0xFFFFFFFF)) ^ k1)
        return ((bits >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32).view(f) - f(1)

    u1, u2 = unit(6), unit(7)
    x = f(2) * (c.astype(f) + u1) / f(width) - f(1)
    y = f(1) - f(2) * (r.astype(f) + u2) / f(height)

    def normalize(vx, vy, vz):
        n = np.sqrt(vx * vx + vy * vy + vz * vz)
        s = np.where(n > f(0), n, f(1))
        return vx / s, vy / s, vz / s

    dx, dy, dz = normalize(x, y, np.ones_like(x))
    m = np.asarray(m33, dtype=f)
    rows = [dx * m[k, 0] + dy * m[k, 1] + dz * m[k, 2] for k in range(3)]
    return np.stack(normalize(*rows), axis=-1)


@pytest.mark.parametrize("key", [0, 7, (5 << 32) | 123456789])
@pytest.mark.parametrize("base", [0, 1000, (1 << 32) - 40])
def test_camera_rays_equal_the_kernel_order_in_numpy(scene0, key, base):
    """Bit for bit, with an odd image and global indices past 2^31 and
    2^32 (the hash takes the low 32 bits)."""
    cfg = RenderConfig(width=37, height=23, spp=5)
    idx = torch.arange(base, base + 300, dtype=torch.int64)
    p, d = camera_rays(scene0, cfg, key, idx)
    want = np_camera_ray(scene0.cam_m33.numpy(), cfg.width, cfg.height, cfg.spp, key,
                         idx.numpy())
    assert d.dtype == torch.float32 and not p.any()
    assert np.array_equal(d.numpy().view(np.uint32), want.view(np.uint32))


def test_camera_inputs_are_the_old_launch_tensors(scene0):
    cfg = RenderConfig(width=8, height=6, spp=3)
    a = camera_inputs(scene0, cfg, Camera(100, 60, 9))  # 144 samples: 16 past the end
    idx = torch.arange(100, 160)
    p, d = camera_rays(scene0, cfg, 9, idx)
    assert torch.equal(a["p"], p.T) and torch.equal(a["d"], d.T)
    assert torch.equal(a["alive"][0], (idx < cfg.n_samples).float())
    assert torch.equal(a["orig"][0], idx.to(torch.int32))
    assert all(t.is_contiguous() for t in a.values())


def launch_pair(scene, cfg, key, base, n):
    cam = Camera(base, n, key)
    keys = rng.key_words(key)
    return dict(camera=cam, keys=keys), dict(camera_inputs(scene, cfg, cam), keys=keys)


@pytest.mark.parametrize("clustered", [False, True])
def test_every_wrapper_in_camera_mode_equals_it_fed_camera_rays(scene0, clustered,
                                                                 monkeypatch):
    """B1, B3, B2, B7 and B5/B6 (both sinks) on CPU tensors, whose plain
    versions make the camera's rays with camera_rays: bit-equal to the same
    wrappers fed those rays (and the pixels gathered by sample)."""
    if clustered:
        from inverse_path_tracer_torch.ops.kernels import clusters

        monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 8)
    scene = scene0
    cfg = RenderConfig(width=9, height=7, spp=2, max_bounces=5, cluster_k=8 if clustered else 0)
    cam, rays = launch_pair(scene, cfg, 4, 20, cfg.n_samples - 20 + 6)  # 6 dead lanes
    assert (rk.pack_tables(scene, scene.diffuse, cfg).cluster_k > 0) is clustered
    mats = scene.diffuse
    n = cam["camera"].n
    g = torch.from_numpy(np.random.default_rng(1).random((3, n)).astype(np.float32))
    for fn in (rk.render_tile, rk.render_tile_rec, rk.render_tile_plain, rk.render_tile_rec_plain):
        for x, y in zip(fn(mats, scene, cfg, **cam), fn(mats, scene, cfg, **rays)):
            assert torch.equal(x, y), fn.__name__
    assert torch.equal(rk.grad_tile(mats, scene, cfg, g=g, **cam),
                       rk.grad_tile(mats, scene, cfg, g=g, **rays))
    assert torch.equal(sk.init_tile(mats, scene, cfg, camera=cam["camera"]),
                       sk.init_tile(mats, scene, cfg, rays["p"], rays["d"], rays["alive"]))
    image = torch.from_numpy(np.random.default_rng(2).random((cfg.width * cfg.height, 3))
                             .astype(np.float32))
    pix = image[(rays["orig"][0].long() // cfg.spp).clamp(0, cfg.width * cfg.height - 1)].T
    pix = pix.contiguous()
    for x, y in zip(ik.inverse_tile_rec(scene, cfg, **cam), ik.inverse_tile_rec(scene, cfg, **rays)):
        assert torch.equal(x, y)
    for fn in (ik.inverse_tile, ik.inverse_tile_global):
        for x, y in zip(fn(scene, cfg, image=image, **cam), fn(scene, cfg, pix=pix, **rays)):
            assert torch.equal(x, y), fn.__name__


def test_fused_launches_pass_a_camera_and_no_tensor(scene0):
    """The fused paths' _launches yields a Camera and the bounce keys per
    launch, no tensor; the external route still slices the caller's rays."""
    cfg = RenderConfig(width=8, height=8, spp=4, tile_size=100)
    launches = list(forward._launches(scene0, cfg, 3, 10, 250, None, camera_key=5))
    assert [(lo, hi) for lo, hi, _ in launches] == [(0, 100), (100, 200), (200, 250)]
    for lo, hi, a in launches:
        assert set(a) == {"camera", "keys"} and a["keys"] == rng.key_words(3)
        assert a["camera"] == Camera(10 + lo, hi - lo, 5)
        assert not any(isinstance(v, torch.Tensor) for v in a.values())
    ext = forward._External(torch.zeros(250, 3), torch.ones(250, 3),
                            torch.rand(cfg.max_bounces * 8, 250))
    (_, _, a), *_ = forward._launches(scene0, cfg, 3, 10, 250, ext)
    assert a["p"].shape == (3, 100) and a["keys"] is None and "camera" not in a


def test_the_extraction_passes_the_camera_and_the_image(scene0, monkeypatch):
    """The kernel route of trace_transport_range gives B5 the camera (under
    the camera stream's key) and the target image, no rays or pixels."""
    cfg = RenderConfig(width=6, height=5, spp=2, max_bounces=3, tile_size=25)
    seen = []
    real = inverse.inverse_tile

    def spy(scene, c, **kw):
        seen.append(kw)
        return real(scene, c, **kw)

    monkeypatch.setattr(inverse, "inverse_tile", spy)
    img = torch.rand((5, 6, 3), generator=torch.Generator().manual_seed(0))
    trace_transport_range(scene0, img, 4, cfg, 0, cfg.n_samples, **CPU)
    assert len(seen) == 3
    for k, kw in enumerate(seen):
        assert set(kw) == {"camera", "keys", "image", "tables"}
        assert kw["camera"] == Camera(25 * k, min(25, cfg.n_samples - 25 * k),
                                      rng.fold_in(4, rng.CAMERA_STREAM))
        assert torch.equal(kw["image"], img.reshape(-1, 3))


def test_fused_paths_equal_the_launches_fed_camera_rays(scene0):
    """render_range, grad_range and trace_transport_range (fused, the camera
    route) equal the same launches fed camera_rays' rays through the plain
    versions, bit for bit."""
    cfg = RenderConfig(width=7, height=6, spp=3, max_bounces=5, tile_size=50)
    start, count, key = 4, 120, 6
    mats = scene0.diffuse
    vals, _ = render_range(mats, scene0, key, cfg, start, count, **CPU)
    g_vals = torch.from_numpy(np.random.default_rng(3).random((count, 3)).astype(np.float32))
    dm = grad_range(mats, scene0, key, cfg, start, count, g_vals, **CPU)
    img = torch.rand((6, 7, 3), generator=torch.Generator().manual_seed(1))
    grids, _ = trace_transport_range(scene0, img, key, cfg, start, count, **CPU)
    want_dm = torch.zeros_like(dm)
    want_grid = torch.zeros((scene0.n_tri + 1, scene0.n_tri, 9), dtype=torch.float64)
    flat = img.reshape(-1, 3)
    for lo in range(0, count, cfg.tile_size):
        n = min(cfg.tile_size, count - lo)
        _, rays = launch_pair(scene0, cfg, key, start + lo, n)
        rad, _ = rk.render_tile_plain(mats, scene0, cfg, **rays)
        assert torch.equal(vals[lo:lo + n], rad.T)
        want_dm = want_dm + rk.grad_tile_plain(mats, scene0, cfg,
                                               g=g_vals[lo:lo + n].T.contiguous(), **rays)
        _, inv = launch_pair(scene0, cfg, rng.fold_in(key, rng.CAMERA_STREAM), start + lo, n)
        inv["keys"] = rng.key_words(key)
        last = cfg.width * cfg.height - 1
        pix = flat[(inv["orig"][0].long() // cfg.spp).clamp(0, last)].T.contiguous()
        want_grid += ik.inverse_tile_plain(scene0, cfg, pix=pix, **inv)[0]
    assert torch.equal(dm, want_dm)
    assert torch.equal(grids.w_sum, ik.grids_from_acc(want_grid).w_sum)
    assert torch.equal(grids.count, ik.grids_from_acc(want_grid).count)


def test_cpu_routes_leave_the_launch_counters_alone(scene0):
    cfg = RenderConfig(width=6, height=4, spp=2, max_bounces=4)
    cam, _ = launch_pair(scene0, cfg, 2, 0, cfg.n_samples)
    n = cam["camera"].n
    counters = [(f, a) for f in (rk.render_tile, rk.render_tile_rec, rk.grad_tile,
                                 sk.init_tile, sk.stage_reverse_tile, ik.inverse_tile,
                                 ik.inverse_tile_global, ik.inverse_tile_rec)
                for a in ("launches", "blocks") if hasattr(f, a)]
    before = [getattr(f, a) for f, a in counters]
    mats = scene0.diffuse
    rk.render_tile(mats, scene0, cfg, **cam)
    rk.render_tile_rec(mats, scene0, cfg, **cam)
    rk.grad_tile(mats, scene0, cfg, g=torch.ones((3, n)), **cam)
    sk.init_tile(mats, scene0, cfg, camera=cam["camera"])
    image = torch.zeros((cfg.width * cfg.height, 3))
    ik.inverse_tile(scene0, cfg, image=image, **cam)
    ik.inverse_tile_global(scene0, cfg, image=image, **cam)
    ik.inverse_tile_rec(scene0, cfg, **cam)
    big = large_scene()
    c4 = RenderConfig(width=4, height=4, spp=2, max_bounces=4)
    rec = torch.zeros((4 * 16, 32))
    sk.stage_reverse_tile(big.n_tri, c4, 4, rec, torch.ones((3, 32)), torch.zeros((4, 32)))
    assert [getattr(f, a) for f, a in counters] == before


def test_camera_mode_argument_checks(scene0):
    cfg = RenderConfig(width=4, height=4, spp=2, max_bounces=3)
    cam, rays = launch_pair(scene0, cfg, 1, 0, cfg.n_samples)
    mats = scene0.diffuse
    with pytest.raises(ValueError, match="replaces"):
        rk.render_tile(mats, scene0, cfg, p=rays["p"], **cam)
    with pytest.raises(ValueError, match="keys"):
        rk.render_tile(mats, scene0, cfg, camera=cam["camera"])
    with pytest.raises(ValueError, match="rays"):
        rk.render_tile(mats, scene0, cfg, keys=cam["keys"])
    with pytest.raises(ValueError, match="image"):
        ik.inverse_tile(scene0, cfg, pix=torch.zeros((3, cfg.n_samples)), **cam)
    with pytest.raises(ValueError, match="image"):
        ik.inverse_tile(scene0, cfg, image=torch.zeros((cfg.width * cfg.height, 3)), **rays)
    with pytest.raises(ValueError, match="image"):
        ik.inverse_tile_global(scene0, cfg, image=torch.zeros((5, 3)), **cam)
    with pytest.raises(ValueError, match="replaces"):
        sk.init_tile(mats, scene0, cfg, rays["p"], camera=cam["camera"])


def test_camera_pixels_past_2_31_samples(scene0):
    """Past 2^31 samples the int32 orig wraps; camera mode reads each
    lane's pixel from its 64-bit global index, as the kernels' lane_pix
    does: B5 and the global sink's plain versions equal them fed the pixels
    gathered at the int64 index, and the wavefront route agrees with the
    kernel route on the pixel sums."""
    cfg = RenderConfig(width=16, height=16, spp=1 << 24, max_bounces=3, tile_size=64)
    base, n = (1 << 31) - 50, 100
    cam, rays = launch_pair(scene0, cfg, 6, base, n)
    image = torch.from_numpy(np.random.default_rng(3).random((cfg.width * cfg.height, 3))
                             .astype(np.float32))
    idx = torch.arange(base, base + n)
    pix = image[idx // cfg.spp].T.contiguous()
    wrapped = image[(rays["orig"][0].long() // cfg.spp).clamp(0, cfg.width * cfg.height - 1)].T
    assert not torch.equal(pix, wrapped)  # the int32 index would pick other pixels
    for fn in (ik.inverse_tile, ik.inverse_tile_global):
        for x, y in zip(fn(scene0, cfg, image=image, **cam), fn(scene0, cfg, pix=pix, **rays)):
            assert torch.equal(x, y), fn.__name__
    img = image.reshape(cfg.height, cfg.width, 3)
    auto, st = trace_transport_range(scene0, img, 6, cfg, base, n, **CPU)
    wave, st_w = trace_transport_range(scene0, img, 6, cfg.with_(backend="plain"), base, n, **CPU)
    assert [int(x) for x in st] == [int(x) for x in st_w]
    assert float(auto.pixel_sum[:, 0].abs().sum()) > 0
    torch.testing.assert_close(wave.pixel_sum[:, 0], auto.pixel_sum[:, 0], rtol=1e-4, atol=1e-5)

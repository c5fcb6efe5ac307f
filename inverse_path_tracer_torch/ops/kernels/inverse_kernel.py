"""Wrappers of the inverse (transport-graph) kernels and their plain
PyTorch versions.

    inverse_tile / inverse_tile_plain          B5, the inverse bounce loop
                                               accumulating the dense edge grid
                                               in shared memory
    inverse_tile_global / inverse_tile_plain(kernel_order=True)
                                               B6 with the global-grid sink:
                                               the same loop adding each edge
                                               to a float64 grid in global
                                               memory
    inverse_tile_rec / inverse_tile_rec_plain  B6 with the records sink: the
                                               same loop streaming per-bounce
                                               edge records

They take the arguments of the JAX package's inverse_tile_pallas and
inverse_tile_pallas_rec (ops/pallas/inverse_kernel.py:271, :338):

    p, d      (3, n) float32 ray origins / directions
    alive     (1, n) float32 0/1 initial alive mask
    pix       (3, n) float32 observed pixel colour of each ray's pixel (B5
              and the global sink; records carry none, the reduction
              applies them)
    orig      (1, n) int32 global sample indices (the fused RNG's counter)
    uniforms  (max_bounces*8, n) float32: rows b*8 + [spec, pick, r1, r2,
              rr, phi, theta, -] of bounce b (external RNG), or None
    keys      (k0, k1) uint32 key words (fused RNG), or None
    camera    in place of p, d, alive and orig (render_kernel.py): the
              primary rays of ops/camera.py Camera(base, n, key), made in
              the kernel; pix is then `image` (W*H, 3) float32, the target
              image, whose row clip(g // spp, 0, W*H-1) is sample g's pixel

and return, beside per-lane segment and shadow-ray counts (2, n) counted
as B1 counts them:

    B5      the dense grid (nT+1, nT, 9) float32 in global triangle
            indices, grid[dst, src] = [w, w*f0, w*f0*pix(3),
            w*f0*light(3), n] (inverse_kernel.py:50-51; dst == nT is the
            eye);
    global  that grid in float64, added into the caller's accumulator
            `acc`, in the kernels' triangle order: internal on clustered
            scenes (ops/kernels/clusters.py), mapped back by unperm_grid
            once per range;
    records (max_bounces*8, n), rows b*8 + [dst, src, hit, w, nee_ok,
            nee_w, e_idx, 0] of bounce b (:240-245), zero past a ray's last
            bounce, internal indices on clustered scenes (:358-359);
            grids_from_edge_records reduces them to the grid, mapping the
            indices back with the tables' perm.

The kernels need cfg.p_spec == 0, as the Pallas ones do (:289); so do
their plain versions, which run the same loop.  The extraction
(render/inverse.py trace_transport_range) takes B5 where its grid and the
scene tables fit one block's shared memory (inverse_grid_fits(), about nT
<= 78) and B6's global-grid sink on larger scenes; the records sink runs
only when a caller asks for records (inverse_tile_rec).  grids_from_acc
turns a grid into render/inverse.py's TransportGrids.

Each wrapper launches its CUDA kernel (inverse.cu) for CUDA tensors and
runs its plain version for CPU tensors; it never falls back from one to the
other on a CUDA tensor.  `<wrapper>.launches` counts kernel launches; each
call runs under the span ipt.launch.<wrapper> (utils/profiling.py).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.bsdf import INV_PI
from inverse_path_tracer_torch.ops.camera import Camera, pixel_index, sample_index
from inverse_path_tracer_torch.ops.intersect import smooth_normal
from inverse_path_tracer_torch.ops.kernels.clusters import kernel_view
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    KernelTables,
    Keys,
    _check,
    _check_launch,
    _count_sweep,
    _default_orig,
    _library,
    _on_card,
    _raise_on,
    _ray_inputs,
    _refuse_bvh,
    _trace_params,
    sweep,
)
from inverse_path_tracer_torch.ops.sampling import (
    pick_emissive,
    sample_emissive_point,
    sample_next_dir,
)
from inverse_path_tracer_torch.ops.vec import dot3, normalize3
from inverse_path_tracer_torch.scene.build import SceneData
from inverse_path_tracer_torch.utils.profiling import spanned

N_QUANT = 9  # w, w*f0, w*f0*pix(3), w*f0*light(3), n
REC_INV_ROWS = 8  # dst, src, hit, w, nee_ok, nee_w, e_idx, 0
# Dynamic shared memory one block may opt into on Hopper (227 KB).
MAX_SMEM_BYTES = 232448


def _padded(count: int) -> int:
    return (count + 3) & ~3


def inverse_grid_fits(scene: SceneData) -> bool:
    """True when B5's per-block grid (nT+1)*nT*9 floats and the scene tables
    (render_common.cuh table_floats) fit in one block's shared memory: about
    nT <= 78 on a flat scene with two emitters.  Larger scenes take B6."""
    nt, ne = scene.n_tri, scene.n_emissive
    etab_stride = 27 if scene.has_vertex_normals else 17
    floats = (_padded((nt + 1) * nt * N_QUANT) + 2 * _padded(nt * 16)
              + (_padded(nt * 20) if scene.has_vertex_normals else 0)
              + _padded(ne * etab_stride) + _padded(ne))
    return 4 * floats <= MAX_SMEM_BYTES


def _check_inverse(cfg, scene, p, d, alive, uniforms, orig, keys, camera) -> int:
    n = _check_launch(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    if cfg.p_spec != 0.0:
        raise ValueError(f"the inverse kernels need p_spec == 0 (got {cfg.p_spec}); "
                         "pass backend='plain' for the general path")
    return n


def _pixels(cfg, scene, n, pix, image, camera) -> torch.Tensor:
    """The pixel input of B5 and the global sink: pix (3, n), or in camera
    mode the image (W*H, 3)."""
    if camera is None:
        if pix is None or image is not None:
            raise ValueError("pass pix (3, n) with the rays (image goes with camera)")
        _check(pix, {"pix": (pix, (3, n), torch.float32)})
        return pix
    if image is None or pix is not None:
        raise ValueError("camera mode takes the target image (W*H, 3), not pix")
    _check(scene.vertices, {"image": (image, (cfg.width * cfg.height, 3), torch.float32)})
    return image


def _plain_pixels(cfg, camera, pix, image) -> torch.Tensor:
    """pix (3, n) of the plain versions: given, or in camera mode the
    image's row of each lane's pixel, from its 64-bit global sample index
    (ops/camera.py pixel_index)."""
    if image is None:
        return pix
    return image[pixel_index(cfg, sample_index(camera, image.device))].T.contiguous()


@spanned("ipt.launch.inverse_tile")
def inverse_tile(
    scene: SceneData,
    cfg,
    p: Optional[torch.Tensor] = None,
    d: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    pix: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    orig: Optional[torch.Tensor] = None,
    keys: Optional[Keys] = None,
    *,
    camera: Optional[Camera] = None,
    image: Optional[torch.Tensor] = None,
    tables: Optional[KernelTables] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5: the dense edge grid (nT+1, nT, 9), in global triangle order, and
    the counts (2, n) of one range of rays.  `tables` is pack_tables(scene,
    scene.diffuse, cfg), packed here when not given."""
    n = _check_inverse(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    pixels = _pixels(cfg, scene, n, pix, image, camera)
    if not _on_card(p, scene):
        return inverse_tile_plain(scene, cfg, p, d, alive, pix, uniforms, orig, keys,
                                  camera=camera, image=image)
    if not inverse_grid_fits(scene):
        raise ValueError(f"inverse_tile keeps the (nT+1, nT, 9) grid in shared memory, which "
                         f"does not fit at nT = {scene.n_tri}; use inverse_tile_global")
    lib = _library("inverse")
    params, tabs = _trace_params(scene.diffuse, scene, cfg, tables, p, d, alive, uniforms,
                                 _default_orig(p, orig), keys, camera)
    _refuse_bvh(tabs, "inverse_tile")
    nt, dev = scene.n_tri, scene.device
    stats = torch.empty((2, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        blocks = ctypes.c_int(0)
        _raise_on(lib, lib.ipt_inverse_grid_blocks(ctypes.byref(params), ctypes.byref(blocks)),
                  "inverse grid occupancy")
        partials = torch.empty((blocks.value, nt + 1, nt, N_QUANT), dtype=torch.float32,
                               device=dev)
        next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.ipt_inverse_grid(ctypes.byref(params), pixels.data_ptr(), partials.data_ptr(),
                                   stats.data_ptr(), next_ray.data_ptr(), blocks.value,
                                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "inverse grid")
    inverse_tile.launches += 1
    _count_sweep(tabs)
    return unperm_grid(partials.sum(dim=0, dtype=torch.float64).float(), tabs.perm), stats


@spanned("ipt.launch.inverse_tile_rec")
def inverse_tile_rec(
    scene: SceneData,
    cfg,
    p: Optional[torch.Tensor] = None,
    d: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    orig: Optional[torch.Tensor] = None,
    keys: Optional[Keys] = None,
    *,
    camera: Optional[Camera] = None,
    tables: Optional[KernelTables] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6: the edge records (max_bounces*8, n), internal indices on
    clustered scenes, and the counts (2, n).  The pixel colours enter in
    the reduction (grids_from_edge_records)."""
    n = _check_inverse(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    if not _on_card(p, scene):
        return inverse_tile_rec_plain(scene, cfg, p, d, alive, uniforms, orig, keys,
                                      camera=camera)
    lib = _library("inverse")
    params, tabs = _trace_params(scene.diffuse, scene, cfg, tables, p, d, alive, uniforms,
                                 _default_orig(p, orig), keys, camera)
    _refuse_bvh(tabs, "inverse_tile_rec")
    dev = scene.device
    rec = torch.empty((cfg.max_bounces * REC_INV_ROWS, n), dtype=torch.float32, device=dev)
    stats = torch.empty((2, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ipt_inverse_rec(ctypes.byref(params), rec.data_ptr(), stats.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "inverse records")
    inverse_tile_rec.launches += 1
    _count_sweep(tabs)
    return rec, stats


@spanned("ipt.launch.inverse_tile_global")
def inverse_tile_global(
    scene: SceneData,
    cfg,
    p: Optional[torch.Tensor] = None,
    d: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    pix: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    orig: Optional[torch.Tensor] = None,
    keys: Optional[Keys] = None,
    *,
    camera: Optional[Camera] = None,
    image: Optional[torch.Tensor] = None,
    tables: Optional[KernelTables] = None,
    acc: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6 with the global-grid sink: adds the edges of one range of rays to
    `acc`, the (nT+1, nT, 9) float64 grid in the kernels' triangle order
    (internal on clustered scenes; unperm_grid maps it back), zeros made
    here when not given, and returns (acc, the counts (2, n)).  The same
    grid as inverse_tile_plain(..., kernel_order=True) up to the order of
    the float64 sums."""
    n = _check_inverse(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    nt, dev = scene.n_tri, scene.device
    pixels = _pixels(cfg, scene, n, pix, image, camera)
    if (nt + 1) * nt * N_QUANT >= 2**31:
        raise ValueError(f"the (nT+1, nT, 9) grid of nT = {nt} does not fit the kernel's int32 "
                         "bin indices")
    if acc is None:
        acc = torch.zeros((nt + 1, nt, N_QUANT), dtype=torch.float64, device=dev)
    _check(pixels, {"acc": (acc, (nt + 1, nt, N_QUANT), torch.float64)})
    if not _on_card(p, scene):
        grid, stats = inverse_tile_plain(scene, cfg, p, d, alive, pix, uniforms, orig, keys,
                                         kernel_order=True, camera=camera, image=image)
        return acc.add_(grid), stats
    lib = _library("inverse")
    params, tabs = _trace_params(scene.diffuse, scene, cfg, tables, p, d, alive, uniforms,
                                 _default_orig(p, orig), keys, camera)
    _refuse_bvh(tabs, "inverse_tile_global")
    stats = torch.empty((2, n), dtype=torch.float32, device=dev)
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ipt_inverse_global(ctypes.byref(params), pixels.data_ptr(), acc.data_ptr(),
                                     stats.data_ptr(), next_ray.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "inverse global grid")
    inverse_tile_global.launches += 1
    _count_sweep(tabs)
    return acc, stats


inverse_tile.launches = 0
inverse_tile_rec.launches = 0
inverse_tile_global.launches = 0


def unperm_grid(grid: torch.Tensor, perm: Optional[torch.Tensor]) -> torch.Tensor:
    """A grid (nT+1, nT, 9) in internal indices -> global ones on both axes
    (the eye row nT stays; JAX inverse_kernel.py:422-433)."""
    if perm is None:
        return grid
    nt = perm.shape[0]
    to_g = torch.cat([perm, torch.tensor([nt], device=perm.device)])
    out = torch.zeros_like(grid)
    out[to_g[:, None], perm[None, :]] = grid
    return out


def inverse_tile_rec_plain(scene, cfg, p=None, d=None, alive=None, uniforms=None, orig=None,
                           keys=None, *, camera: Optional[Camera] = None):
    """B6's plain version: the inverse bounce loop of _kernel_inv
    (inverse_kernel.py:135-249) over all lanes at once.  The next ray is
    intersected on every lane; the kernel sweeps it only where the path
    goes on, and the lanes that stop never read it.  Per bounce:

      the indirect edge dst -> src with weight w (f0 = 1), before roulette;
      roulette on slot 4; a cosine direction about the face normal (slots 5,
      6), `cosine` against the shading normal, w_next = w*cosine*pi/p_rr;
      NEE with the CDF pick on slot 1 and the sqrt(r1) point (slots 2, 3):
      nee_w = w cos(theta) cos(theta') / t^2 / p_light on the edge
      src -> emitter (f0 = 1/pi, light = the emitter's emission).

    A reached bounce that misses records dst and w with hit = 0.  Indices
    are those of the kernels' view (internal on clustered scenes).  In
    camera mode the rays are the plain camera_rays'."""
    _check_inverse(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    p, d, alive, orig = _ray_inputs(scene, cfg, p, d, alive, orig, camera)
    return _records_plain(kernel_view(scene, cfg), cfg, p, d, alive, uniforms, orig, keys)


def _records_plain(view, cfg, p, d, alive, uniforms, orig, keys):
    """inverse_tile_rec_plain's loop on the rays (p, d, alive, orig) and the
    kernels' view of the scene."""
    scene = view.scene
    n, nt = p.shape[1], scene.n_tri
    h_orig = rng.hash_orig(keys, orig[0]) if keys is not None else None
    cos_scale = math.pi / cfg.p_rr

    def isect(o, dirs):
        return sweep(view, cfg, o, dirs)

    def masked(x, m):
        return torch.where(m, x, torch.zeros_like(x))

    cur = isect(p.T.contiguous(), d.T.contiguous())
    live = alive[0] > 0
    w = torch.ones(n, dtype=torch.float32, device=p.device)
    dst = torch.full((n,), nt, dtype=torch.int64, device=p.device)
    segs = torch.zeros_like(w)
    shadows = torch.zeros_like(w)
    rec = torch.zeros((cfg.max_bounces * REC_INV_ROWS, n), dtype=torch.float32, device=p.device)
    zero = torch.zeros_like(w)

    for b in range(cfg.max_bounces):
        if not bool(live.any()):
            break
        u = rng.draw(keys, h_orig, b, range(7)) if keys is not None else uniforms[8 * b : 8 * b + 7]
        hit_act = live & cur.hit
        src = cur.tri
        face_n = scene.face_normal[src]
        shade_n = smooth_normal(scene, src, cur.point)
        cont = hit_act & (u[4] < cfg.p_rr)
        next_dir, _ = sample_next_dir(face_n, None, zero, u[5], u[6])
        cosine = dot3(next_dir, shade_n)
        w_next = w * cosine * cos_scale
        if scene.n_emissive > 0:
            e_tri, e_p = pick_emissive(scene, u[1])
            to_light = normalize3(sample_emissive_point(scene, e_tri, u[2], u[3]) - cur.point)
            cos_theta = dot3(shade_n, to_light)
            sh = isect(cur.point, to_light)
            nxt = isect(cur.point, next_dir)
            light_n = smooth_normal(scene, e_tri, sh.point)
            cos_theta_p = -dot3(light_n, to_light)
            ok = hit_act & (cos_theta >= 0) & sh.hit & (cos_theta_p >= 0) & (sh.tri == e_tri)
            st = torch.where(ok, sh.t, torch.ones_like(sh.t))
            nee_w = masked(w * cos_theta * cos_theta_p / (st * st) / e_p, ok)
            e_idx = masked(e_tri, hit_act)
            shadows = shadows + hit_act.float()
        else:
            nxt = isect(cur.point, next_dir)
            ok = torch.zeros_like(hit_act)
            nee_w = zero
            e_idx = torch.zeros_like(src)
        segs = segs + live.float()
        rows = [masked(dst, live).float(), masked(src, hit_act).float(), hit_act.float(),
                masked(w, live), ok.float(), nee_w, e_idx.float(), zero]
        rec[b * REC_INV_ROWS : (b + 1) * REC_INV_ROWS] = torch.stack(rows)
        w = torch.where(cont, w_next, w)
        dst = torch.where(cont, src, dst)
        live = cont
        cur = nxt

    return rec, torch.stack([segs, shadows], dim=0)


def inverse_tile_plain(scene, cfg, p=None, d=None, alive=None, pix=None, uniforms=None,
                       orig=None, keys=None, *, kernel_order=False,
                       camera: Optional[Camera] = None, image: Optional[torch.Tensor] = None):
    """B5's plain version, and that of B6's global-grid sink: B6's plain
    records reduced to the dense grid.  B5's is float32 in global triangle
    order; with kernel_order, the global sink's, float64 in the kernels'
    order (internal on clustered scenes)."""
    n = _check_inverse(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    _pixels(cfg, scene, n, pix, image, camera)
    p, d, alive, orig = _ray_inputs(scene, cfg, p, d, alive, orig, camera)
    pix = _plain_pixels(cfg, camera, pix, image)
    view = kernel_view(scene, cfg)
    rec, stats = _records_plain(view, cfg, p, d, alive, uniforms, orig, keys)
    if kernel_order:
        return grids_from_edge_records(rec, pix.T, view.scene, cfg), stats
    return grids_from_edge_records(rec, pix.T, scene, cfg, view.perm).float(), stats


def grids_from_edge_records(
    rec: torch.Tensor, pix: torch.Tensor, scene: SceneData, cfg,
    perm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B6's records (max_bounces*8, n) and the pixel colours (n, 3) -> the
    dense grid (nT+1, nT, 9) in float64, in global triangle order (the
    counterpart of _grids_from_edge_records, render/inverse.py:350).  perm
    (the tables' perm) maps the internal indices of clustered records
    back; the eye (dst nT) stays.

    Per bounce, the lanes whose hit (indirect edge) or nee_ok (NEE edge) is
    set are selected by index and their quantities index_add_-ed into flat
    bins dst*nT + src.  Masked lanes are dropped, never multiplied by their
    mask, so the NaN a masked lane may hold cannot leak, and they add no
    atomics to one bin.  The quantities are formed in float32, as the kernel
    forms them, and summed in float64: with no prefix sums there is no
    cancellation, so small bins stay exact beside ~1e13 totals.  Negative
    weights are summed as they are."""
    nt = scene.n_tri
    n = rec.shape[1]
    if tuple(rec.shape) != (cfg.max_bounces * REC_INV_ROWS, n) or tuple(pix.shape) != (n, 3):
        raise ValueError(f"records {tuple(rec.shape)} / pixels {tuple(pix.shape)} do not match "
                         f"max_bounces={cfg.max_bounces}, n={n}")
    grid = torch.zeros(((nt + 1) * nt, N_QUANT), dtype=torch.float64, device=rec.device)
    pix = pix.to(torch.float32)
    if perm is None:
        to_g = torch.arange(nt + 1, device=rec.device)
    else:
        to_g = torch.cat([perm, torch.tensor([nt], device=rec.device)])
    for b in range(cfg.max_bounces):
        r = rec[b * REC_INV_ROWS : (b + 1) * REC_INV_ROWS]
        ind = torch.nonzero(r[2] > 0).squeeze(1)
        nee = torch.nonzero(r[4] > 0).squeeze(1)
        src_nee, e = to_g[r[1, nee].long()], to_g[r[6, nee].long()]
        grid.index_add_(0, to_g[r[0, ind].long()] * nt + to_g[r[1, ind].long()],
                        _quantities(r[3, ind], 1.0, pix[ind], None))
        grid.index_add_(0, src_nee * nt + e,
                        _quantities(r[5, nee], INV_PI, pix[nee], scene.emission[e]))
    return grid.reshape(nt + 1, nt, N_QUANT)


def _quantities(w, f0, pix, light):
    """(m, 9) float64 edge quantities [w, w*f0, w*f0*pix, w*f0*light, 1]
    (light None: the indirect edge, which carries none)."""
    wf = (w * f0)[:, None]
    light_cols = torch.zeros_like(pix) if light is None else wf * light
    return torch.cat([w[:, None], wf, wf * pix, light_cols, torch.ones_like(wf)], dim=1).double()


def grids_from_acc(acc: torch.Tensor):
    """Dense grid (nT+1, nT, 9) -> TransportGrids (inverse_kernel.py:412),
    in float32.  The SPECULAR channel is zero: the kernels need p_spec == 0,
    and compress reads only the DIFFUSE channel."""
    from inverse_path_tracer_torch.render.inverse import TransportGrids

    a = acc.to(torch.float32).reshape(-1, N_QUANT)
    z1 = torch.zeros_like(a[:, 0])
    z3 = torch.zeros_like(a[:, 2:5])
    return TransportGrids(
        w_sum=a[:, 0].contiguous(),
        pixel_sum=torch.stack([a[:, 2:5], z3], dim=1),
        light_sum=torch.stack([a[:, 5:8], z3], dim=1),
        factors_sum=torch.stack([a[:, 1], z1], dim=1),
        count=a[:, 8].contiguous(),
    )

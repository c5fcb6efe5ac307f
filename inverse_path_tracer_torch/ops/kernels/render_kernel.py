"""Forward megakernel wrapper (render_tile) and its plain PyTorch version
(render_tile_plain).

Both take the same arguments and return the same outputs as the JAX
package's render_tile_pallas (ops/pallas/render_kernel.py:1440):

    p, d      (3, n) float32 ray origins / directions
    alive     (1, n) float32 0/1 initial alive mask
    orig      (1, n) int32 global sample indices (the fused RNG's counter)
    uniforms  (max_bounces*8, n) float32: rows b*8 + [pick, r1, r2, rr, phi,
              theta, -, -] of bounce b (external RNG), or None
    keys      (k0, k1) uint32 key words (fused RNG), or None
    -> radiance (3, n) float32, stats (2, n) float32 per-lane segment and
       shadow-ray counts.

render_tile launches the CUDA kernel (render_fwd.cu) for CUDA tensors and
runs render_tile_plain for CPU tensors; it never falls back from one to the
other on a CUDA tensor.  render_tile.launches counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.bsdf import INV_2PI, INV_PI, bsdf_from_values
from inverse_path_tracer_torch.ops.intersect import (
    intersect_planes,
    plane_rows,
    smooth_normal,
)
from inverse_path_tracer_torch.ops.sampling import (
    TWO_PI,
    pick_emissive,
    sample_emissive_point,
    sample_next_dir,
)
from inverse_path_tracer_torch.ops.vec import dot3, normalize3
from inverse_path_tracer_torch.scene.build import SceneData

Keys = Tuple[int, int]


@dataclasses.dataclass
class KernelTables:
    """Device tables of the kernel (the counterpart of _pack_tables,
    render_kernel.py:1296, without the bf16 Kd split or cluster data)."""

    planes: torch.Tensor  # (nT, 16) face plane + 3 edge planes
    table: torch.Tensor  # (nT, 16) emission, spec, shin, face_n, kd, pad
    vtab: Optional[torch.Tensor]  # (nT, 20) verts, vertex normals, area, pad
    etab: torch.Tensor  # (nE, 17|27) verts, emission, face_n, tri, p (+vn, area)
    cdf: torch.Tensor  # (nE,)
    no_spec: bool


def pack_tables(scene: SceneData, materials: torch.Tensor) -> KernelTables:
    # flatten(1), not reshape(rows, -1): an emitter-free scene has 0 rows.
    f32 = lambda *xs: torch.cat([x.flatten(1).float() for x in xs], dim=1)
    table = f32(scene.emission, scene.specular, scene.shininess[:, None],
                scene.face_normal, materials, torch.zeros_like(materials))
    ei = scene.emissive_idx
    ecols = [scene.vertices[ei], scene.emission[ei], scene.face_normal[ei],
             ei.float()[:, None], scene.emissive_p[:, None]]
    vtab = None
    if scene.has_vertex_normals:
        vtab = f32(scene.vertices, scene.vertex_normals, scene.area[:, None],
                   torch.zeros_like(scene.area)[:, None])
        ecols += [scene.vertex_normals[ei], scene.area[ei][:, None]]
    return KernelTables(
        planes=plane_rows(scene),
        table=table.contiguous(),
        vtab=None if vtab is None else vtab.contiguous(),
        etab=f32(*ecols).contiguous(),
        cdf=scene.emissive_cdf.float().contiguous(),
        no_spec=scene.specular_idx.shape[0] == 0,
    )


def _check_inputs(cfg, p, d, alive, uniforms, orig, keys):
    n = p.shape[1]
    want = {"p": (p, (3, n), torch.float32), "d": (d, (3, n), torch.float32),
            "alive": (alive, (1, n), torch.float32), "orig": (orig, (1, n), torch.int32)}
    if (uniforms is None) == (keys is None):
        raise ValueError("pass exactly one of uniforms (external RNG) and keys (fused RNG)")
    if uniforms is not None:
        want["uniforms"] = (uniforms, (cfg.max_bounces * 8, n), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def render_tile(
    materials: torch.Tensor,
    scene: SceneData,
    cfg,
    p: torch.Tensor,
    d: torch.Tensor,
    alive: torch.Tensor,
    uniforms: Optional[torch.Tensor] = None,
    orig: Optional[torch.Tensor] = None,
    keys: Optional[Keys] = None,
    *,
    tables: Optional[KernelTables] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render one range of rays: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  `tables` is pack_tables(scene, materials),
    packed here when not given."""
    if orig is None:
        orig = torch.zeros((1, p.shape[1]), dtype=torch.int32, device=p.device)
    _check_inputs(cfg, p, d, alive, uniforms, orig, keys)
    if p.device.type == "cpu":
        return render_tile_plain(materials, scene, cfg, p, d, alive, uniforms, orig, keys)
    if p.device.type != "cuda":
        raise ValueError(f"render_tile runs on CUDA or CPU tensors, got {p.device}")
    if scene.device != p.device or materials.device != p.device:
        raise ValueError(f"scene/materials must be on {p.device}")
    if tables is None:
        tables = pack_tables(scene, materials)
    return _launch(scene, cfg, tables, p, d, alive, uniforms, orig, keys)


render_tile.launches = 0


@functools.lru_cache(maxsize=None)
def _library():
    """The render_fwd library (built on first use), with its C signature."""
    from inverse_path_tracer_torch.ops.kernels.build import load

    lib = load("render_fwd")
    vp, ci, cf, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    lib.ipt_render_fwd.argtypes = [
        vp, vp, vp, vp, vp, cu, cu, ci,  # p d alive orig uniforms k0 k1 fused
        vp, vp, vp, ci, ci,  # planes table vtab n_tri has_vn
        vp, ci, vp, ci,  # etab etab_stride cdf n_emissive
        ci, ci, ci,  # no_spec quirks max_bounces
        cf, cf, cf, cf, cf, cf, cf, cf,  # p_rr min_dot eps 2pi 1/pi 1/2pi pi/p_rr 1/p_rr
        vp, vp, ci, vp,  # rad stats n stream
    ]
    lib.ipt_render_fwd.restype = ci
    lib.ipt_error_string.argtypes = [ci]
    lib.ipt_error_string.restype = ctypes.c_char_p
    return lib


def _launch(scene, cfg, tabs, p, d, alive, uniforms, orig, keys):
    lib = _library()
    dev = p.device
    if tabs.planes.device != dev:
        raise ValueError(f"tables are on {tabs.planes.device}, rays on {dev}")
    n = p.shape[1]
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    stats = torch.empty((2, n), dtype=torch.float32, device=dev)
    fused = keys is not None
    k0, k1 = keys if fused else (0, 0)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ipt_render_fwd(
            ptr(p), ptr(d), ptr(alive), ptr(orig), ptr(uniforms), k0, k1, int(fused),
            ptr(tabs.planes), ptr(tabs.table), ptr(tabs.vtab), scene.n_tri,
            int(tabs.vtab is not None), ptr(tabs.etab), tabs.etab.shape[1],
            ptr(tabs.cdf), scene.n_emissive, int(tabs.no_spec),
            int(cfg.reference_quirks), cfg.max_bounces, cfg.p_rr, cfg.min_dot,
            cfg.epsilon, TWO_PI, INV_PI, INV_2PI, math.pi / cfg.p_rr, 1.0 / cfg.p_rr,
            ptr(rad), ptr(stats), n, stream,
        )
    if err != 0:
        raise RuntimeError(f"render_fwd launch failed: {lib.ipt_error_string(err).decode()}")
    render_tile.launches += 1
    return rad, stats


def render_tile_plain(
    materials: torch.Tensor,
    scene: SceneData,
    cfg,
    p: torch.Tensor,
    d: torch.Tensor,
    alive: torch.Tensor,
    uniforms: Optional[torch.Tensor] = None,
    orig: Optional[torch.Tensor] = None,
    keys: Optional[Keys] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch on any device: the bounce step of
    the JAX XLA path (render/forward.py:232-350) over all lanes at once,
    with the next ray's intersection fused behind the shadow ray as in the
    kernel."""
    if orig is None:
        orig = torch.zeros((1, p.shape[1]), dtype=torch.int32, device=p.device)
    _check_inputs(cfg, p, d, alive, uniforms, orig, keys)
    n = p.shape[1]
    quirks = cfg.reference_quirks
    no_spec = scene.specular_idx.shape[0] == 0
    planes = plane_rows(scene)
    h_orig = rng.hash_orig(keys, orig[0]) if keys is not None else None

    def isect(o, dirs):
        return intersect_planes(planes, o, dirs, cfg.min_dot, cfg.epsilon)

    def masked(x, m):
        return torch.where(m.reshape(-1, *([1] * (x.dim() - 1))), x, torch.zeros_like(x))

    dirs = d.T.contiguous()
    cur = isect(p.T.contiguous(), dirs)
    zero3 = torch.zeros_like(dirs)
    radiance, l_e, l_d, pm = zero3, zero3, zero3, torch.ones_like(dirs)
    live = alive[0] > 0
    segs = torch.zeros(n, dtype=torch.float32, device=p.device)
    shadows = torch.zeros_like(segs)

    for b in range(cfg.max_bounces):
        if not bool(live.any()):
            break
        u = rng.draw(keys, h_orig, b, range(6)) if keys is not None else uniforms[8 * b : 8 * b + 6]
        hit_act = live & cur.hit
        tri = cur.tri
        emission = masked(scene.emission[tri], cur.hit)
        spec = masked(scene.specular[tri], cur.hit)
        shin = masked(scene.shininess[tri], cur.hit)
        face_n = masked(scene.face_normal[tri], cur.hit)
        kd = masked(materials[tri], cur.hit)
        shade_n = masked(smooth_normal(scene, tri, cur.point), cur.hit)
        first_hit = hit_act & (b == 0)
        l_e = torch.where(first_hit[:, None], emission, l_e if quirks else zero3)

        cont = hit_act & (u[3] < cfg.p_rr)
        is_spec = None if no_spec else ((spec != 0).any(dim=-1) & (shin != 0))
        next_dir, pdf = sample_next_dir(face_n, is_spec, shin, u[4], u[5])
        cosine = dot3(next_dir, shade_n)

        if scene.n_emissive > 0:
            e_tri, e_p = pick_emissive(scene, u[0])
            to_light = normalize3(sample_emissive_point(scene, e_tri, u[1], u[2]) - cur.point)
            cos_theta = dot3(shade_n, to_light)
            sh = isect(cur.point, to_light)
            nxt = isect(cur.point, next_dir)
            light_n = smooth_normal(scene, e_tri, sh.point)
            cos_theta_p = -dot3(light_n, to_light)
            ok = (cos_theta >= 0) & sh.hit & (cos_theta_p >= 0) & (sh.tri == e_tri)
            st = torch.where(ok, sh.t, torch.ones_like(sh.t))
            geo = cos_theta * cos_theta_p / st**2 / e_p
            bsdf_direct = kd if no_spec else bsdf_from_values(
                kd, spec, shin, shade_n, dirs, to_light, True)
            l_d_fresh = masked(bsdf_direct * (scene.emission[e_tri] * geo[:, None]), ok)
            shadows = shadows + hit_act.float()
        else:
            nxt = isect(cur.point, next_dir)
            l_d_fresh = zero3
        l_d = torch.where(hit_act[:, None], l_d_fresh, l_d)
        contrib_mask = live if quirks else hit_act
        radiance = radiance + masked(pm * (l_e + l_d), contrib_mask)
        segs = segs + live.float()

        if no_spec:
            bsdf = kd * INV_PI
            coeff = cosine * (math.pi / cfg.p_rr)
        else:
            bsdf = bsdf_from_values(kd, spec, shin, shade_n, dirs, next_dir, False)
            coeff = torch.where(pdf > 0, cosine / pdf * (1.0 / cfg.p_rr),
                                torch.zeros_like(cosine))
        pm = torch.where(cont[:, None], pm * (bsdf * coeff[:, None]), pm)
        dirs = torch.where(cont[:, None], next_dir, dirs)
        live = cont
        cur = nxt

    return radiance.T.contiguous(), torch.stack([segs, shadows], dim=0)

"""Wrappers of the render kernels and their plain PyTorch versions.

    render_tile / render_tile_plain          B1, the forward megakernel
    render_tile_rec / render_tile_rec_plain  B3, B1 that also writes records
    grad_tile / grad_tile_plain              B2, the fused backward (replay +
                                             suffix recursion)
    reverse_tile / reverse_tile_plain        B4, the suffix recursion on B3's
                                             records

They take the arguments and return the outputs of the JAX package's
render_tile_pallas, render_tile_pallas_rec, grad_tile_pallas and
reverse_tile_pallas (ops/pallas/render_kernel.py:1440, :1571, :1505, :1640):

    p, d      (3, n) float32 ray origins / directions
    alive     (1, n) float32 0/1 initial alive mask
    orig      (1, n) int32 global sample indices (the fused RNG's counter)
    uniforms  (max_bounces*8, n) float32: rows b*8 + [pick, r1, r2, rr, phi,
              theta, -, -] of bounce b (external RNG), or None
    keys      (k0, k1) uint32 key words (fused RNG), or None
    g         (3, n) float32 radiance cotangent
    rec       (max_bounces*16, n) float32 records (render/diff.py REC_ROWS)
    -> radiance (3, n), stats (2, n) per-lane segment and shadow-ray counts,
       records, or the material cotangent (nT, 3).

Each wrapper launches its CUDA kernel (render_fwd.cu, render_bwd.cu) for
CUDA tensors and runs its plain version for CPU tensors; it never falls
back from one to the other on a CUDA tensor.  `<wrapper>.launches` counts
kernel launches.
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
from inverse_path_tracer_torch.render.diff import (
    REC_ROWS,
    BounceRecords,
    backward_from_records,
)
from inverse_path_tracer_torch.scene.build import SceneData

Keys = Tuple[int, int]

# render_bwd.cu: records of at most 64 bounces per thread, and kWarps (8) *
# nT * 3 floats of accumulators in at most 227 KB of shared memory.
GRAD_MAX_BOUNCES = 64
GRAD_MAX_TRIANGLES = 2048
_BLOCK = 256  # threads per block of every kernel


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


def _check(p, want):
    """Each named tensor has its (shape, dtype), p's device and a contiguous
    layout."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_inputs(cfg, p, d, alive, uniforms, orig, keys):
    n = p.shape[1]
    want = {"p": (p, (3, n), torch.float32), "d": (d, (3, n), torch.float32),
            "alive": (alive, (1, n), torch.float32), "orig": (orig, (1, n), torch.int32)}
    if (uniforms is None) == (keys is None):
        raise ValueError("pass exactly one of uniforms (external RNG) and keys (fused RNG)")
    if uniforms is not None:
        want["uniforms"] = (uniforms, (cfg.max_bounces * 8, n), torch.float32)
    _check(p, want)


def _check_grad_triangles(n_tri):
    if n_tri > GRAD_MAX_TRIANGLES:
        raise ValueError(f"the gradient kernels take at most {GRAD_MAX_TRIANGLES} triangles "
                         f"(per-warp accumulators in shared memory), got {n_tri}")


def _on_card(p, scene, materials=None) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    if p.device.type == "cpu":
        return False
    if p.device.type != "cuda":
        raise ValueError(f"the render kernels run on CUDA or CPU tensors, got {p.device}")
    if scene.device != p.device or (materials is not None and materials.device != p.device):
        raise ValueError(f"scene/materials must be on {p.device}")
    return True


def _default_orig(p, orig):
    if orig is None:
        return torch.zeros((1, p.shape[1]), dtype=torch.int32, device=p.device)
    return orig


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
    """B1: render one range of rays.  `tables` is pack_tables(scene,
    materials), packed here when not given."""
    orig = _default_orig(p, orig)
    _check_inputs(cfg, p, d, alive, uniforms, orig, keys)
    if not _on_card(p, scene, materials):
        return render_tile_plain(materials, scene, cfg, p, d, alive, uniforms, orig, keys)
    rad, stats, _ = _launch_fwd(materials, scene, cfg, tables, p, d, alive, uniforms, orig,
                                keys, records=False)
    render_tile.launches += 1
    return rad, stats


def render_tile_rec(
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3: render_tile that also returns the records (max_bounces*16, n)."""
    orig = _default_orig(p, orig)
    _check_inputs(cfg, p, d, alive, uniforms, orig, keys)
    if not _on_card(p, scene, materials):
        return render_tile_rec_plain(materials, scene, cfg, p, d, alive, uniforms, orig, keys)
    out = _launch_fwd(materials, scene, cfg, tables, p, d, alive, uniforms, orig, keys,
                      records=True)
    render_tile_rec.launches += 1
    return out


def grad_tile(
    materials: torch.Tensor,
    scene: SceneData,
    cfg,
    p: torch.Tensor,
    d: torch.Tensor,
    alive: torch.Tensor,
    g: torch.Tensor,
    uniforms: Optional[torch.Tensor] = None,
    orig: Optional[torch.Tensor] = None,
    keys: Optional[Keys] = None,
    *,
    tables: Optional[KernelTables] = None,
) -> torch.Tensor:
    """B2: d(sum g * radiance)/d materials (nT, 3) for one range of rays,
    replaying the forward and running the suffix recursion in one kernel."""
    orig = _default_orig(p, orig)
    _check_inputs(cfg, p, d, alive, uniforms, orig, keys)
    _check(p, {"g": (g, (3, p.shape[1]), torch.float32)})
    if not _on_card(p, scene, materials):
        return grad_tile_plain(materials, scene, cfg, p, d, alive, g, uniforms, orig, keys)
    _check_grad_triangles(scene.n_tri)
    if cfg.max_bounces > GRAD_MAX_BOUNCES:
        raise ValueError(f"grad_tile keeps at most {GRAD_MAX_BOUNCES} bounces of records "
                         f"per thread, got max_bounces={cfg.max_bounces}")
    lib = _library("render_bwd")
    params, tabs = _trace_params(materials, scene, cfg, tables, p, d, alive, uniforms, orig, keys)
    partials = _partials(p.shape[1], scene.n_tri, p.device)
    with torch.cuda.device(p.device):
        err = lib.ipt_grad_tile(ctypes.byref(params), g.data_ptr(), partials.data_ptr(),
                                torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, err, "render_bwd grad_tile")
    grad_tile.launches += 1
    return partials.sum(dim=0)


def reverse_tile(n_tri: int, cfg, rec: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B4: the material cotangent (nT, 3) from B3's records and g (3, n)."""
    n = g.shape[1]
    _check(g, {"rec": (rec, (cfg.max_bounces * REC_ROWS, n), torch.float32),
               "g": (g, (3, n), torch.float32)})
    if g.device.type == "cpu":
        return reverse_tile_plain(n_tri, cfg, rec, g)
    if g.device.type != "cuda":
        raise ValueError(f"reverse_tile runs on CUDA or CPU tensors, got {g.device}")
    _check_grad_triangles(n_tri)
    lib = _library("render_bwd")
    partials = _partials(n, n_tri, g.device)
    with torch.cuda.device(g.device):
        err = lib.ipt_reverse_tile(rec.data_ptr(), g.data_ptr(), n, n_tri, cfg.max_bounces,
                                   int(cfg.reference_quirks), INV_PI, partials.data_ptr(),
                                   torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(lib, err, "render_bwd reverse_tile")
    reverse_tile.launches += 1
    return partials.sum(dim=0)


render_tile.launches = 0
render_tile_rec.launches = 0
grad_tile.launches = 0
reverse_tile.launches = 0


class _TraceParams(ctypes.Structure):
    """render_common.cuh TraceParams, field for field."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("p", "d", "alive", "orig", "uniforms", "planes",
                                         "table", "vtab", "etab", "cdf")]
        + [("k0", ctypes.c_uint32), ("k1", ctypes.c_uint32)]
        + [(f, ctypes.c_int) for f in ("n", "n_tri", "n_emissive", "etab_stride", "has_vn",
                                        "no_spec", "quirks", "fused", "max_bounces",
                                        "use_smem")]
        + [(f, ctypes.c_float) for f in ("p_rr", "min_dot", "epsilon", "two_pi", "inv_pi",
                                          "inv_2pi", "cos_scale", "inv_p_rr")]
    )


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """The named kernel library (built on first use), with its C signatures."""
    from inverse_path_tracer_torch.ops.kernels.build import load

    lib = load(name)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    params = ctypes.POINTER(_TraceParams)
    if name == "render_fwd":
        lib.ipt_render_fwd.argtypes = [params, vp, vp, vp, vp]  # rad stats rec stream
        lib.ipt_render_fwd.restype = ci
    else:
        lib.ipt_grad_tile.argtypes = [params, vp, vp, vp]  # g partials stream
        lib.ipt_grad_tile.restype = ci
        # rec g n n_tri max_bounces quirks inv_pi partials stream
        lib.ipt_reverse_tile.argtypes = [vp, vp, ci, ci, ci, ci, cf, vp, vp]
        lib.ipt_reverse_tile.restype = ci
    lib.ipt_error_string.argtypes = [ci]
    lib.ipt_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ipt_error_string(err).decode()}")


def _partials(n: int, n_tri: int, device) -> torch.Tensor:
    """One (nT, 3) partial sum per block of the gradient kernels (none for
    n = 0, where nothing is launched and the sum is zero)."""
    return torch.empty((-(-n // _BLOCK), n_tri, 3), dtype=torch.float32, device=device)


def _trace_params(materials, scene, cfg, tabs, p, d, alive, uniforms, orig, keys):
    """The kernels' TraceParams (pointers into the caller's tensors, which
    must outlive the launch) and the tables they point to."""
    if tabs is None:
        tabs = pack_tables(scene, materials)
    if tabs.planes.device != p.device:
        raise ValueError(f"tables are on {tabs.planes.device}, rays on {p.device}")
    ptr = lambda t: None if t is None else t.data_ptr()
    fused = keys is not None
    k0, k1 = keys if fused else (0, 0)
    params = _TraceParams(
        p=ptr(p), d=ptr(d), alive=ptr(alive), orig=ptr(orig), uniforms=ptr(uniforms),
        planes=ptr(tabs.planes), table=ptr(tabs.table), vtab=ptr(tabs.vtab),
        etab=ptr(tabs.etab), cdf=ptr(tabs.cdf), k0=k0, k1=k1,
        n=p.shape[1], n_tri=scene.n_tri, n_emissive=scene.n_emissive,
        etab_stride=tabs.etab.shape[1], has_vn=int(tabs.vtab is not None),
        no_spec=int(tabs.no_spec), quirks=int(cfg.reference_quirks), fused=int(fused),
        max_bounces=cfg.max_bounces, use_smem=0, p_rr=cfg.p_rr, min_dot=cfg.min_dot,
        epsilon=cfg.epsilon, two_pi=TWO_PI, inv_pi=INV_PI, inv_2pi=INV_2PI,
        cos_scale=math.pi / cfg.p_rr, inv_p_rr=1.0 / cfg.p_rr,
    )
    return params, tabs


def _launch_fwd(materials, scene, cfg, tables, p, d, alive, uniforms, orig, keys, records):
    lib = _library("render_fwd")
    params, tabs = _trace_params(materials, scene, cfg, tables, p, d, alive, uniforms, orig, keys)
    n = p.shape[1]
    dev = p.device
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    stats = torch.empty((2, n), dtype=torch.float32, device=dev)
    rec = (torch.empty((cfg.max_bounces * REC_ROWS, n), dtype=torch.float32, device=dev)
           if records else None)
    with torch.cuda.device(dev):
        err = lib.ipt_render_fwd(ctypes.byref(params), rad.data_ptr(), stats.data_ptr(),
                                 None if rec is None else rec.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "render_fwd")
    return rad, stats, rec


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
    with_records: bool = False,
):
    """The same function in plain PyTorch on any device: the bounce step of
    the JAX XLA path (render/forward.py:232-350) over all lanes at once,
    with the next ray's intersection fused behind the shadow ray as in the
    kernel.  Differentiable in `materials` by torch autograd.

    with_records=True also returns the records (max_bounces*16, n) of
    render/diff.py REC_ROWS, as the JAX _bounce_step does with its
    with_records flag (forward.py:339-349); slots past a ray's last bounce
    are zero."""
    orig = _default_orig(p, orig)
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
    rec = (torch.zeros((cfg.max_bounces * REC_ROWS, n), dtype=torch.float32, device=p.device)
           if with_records else None)

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
            nee = masked(scene.emission[e_tri] * geo[:, None], ok)
            l_d_fresh = masked(bsdf_direct * nee, ok)
            shadows = shadows + hit_act.float()
        else:
            nxt = isect(cur.point, next_dir)
            nee = l_d_fresh = zero3
        l_d = torch.where(hit_act[:, None], l_d_fresh, l_d)
        contrib_mask = live if quirks else hit_act
        c = masked(l_e + l_d, contrib_mask)
        radiance = radiance + masked(pm * c, contrib_mask)
        segs = segs + live.float()

        if no_spec:
            bsdf = kd * INV_PI
            coeff = cosine * (math.pi / cfg.p_rr)
        else:
            bsdf = bsdf_from_values(kd, spec, shin, shade_n, dirs, next_dir, False)
            coeff = torch.where(pdf > 0, cosine / pdf * (1.0 / cfg.p_rr),
                                torch.zeros_like(cosine))
        f = bsdf * coeff[:, None]
        if with_records:
            rows = [masked(f, cont).T, c.T, masked(nee, hit_act).T, masked(pm, live).T,
                    masked(coeff, cont)[None], masked(tri, hit_act).float()[None],
                    hit_act.float()[None], (live & ~cur.hit).float()[None]]
            rec[b * REC_ROWS : (b + 1) * REC_ROWS] = torch.cat(rows).detach()
        pm = torch.where(cont[:, None], pm * f, pm)
        dirs = torch.where(cont[:, None], next_dir, dirs)
        live = cont
        cur = nxt

    stats = torch.stack([segs, shadows], dim=0)
    if with_records:
        return radiance.T.contiguous(), stats, rec
    return radiance.T.contiguous(), stats


def render_tile_rec_plain(materials, scene, cfg, p, d, alive, uniforms=None, orig=None,
                          keys=None):
    """B3's plain version: render_tile_plain with records."""
    return render_tile_plain(materials, scene, cfg, p, d, alive, uniforms, orig, keys,
                             with_records=True)


def reverse_tile_plain(n_tri: int, cfg, rec: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B4's plain version: render/diff.py backward_from_records on the rows."""
    return backward_from_records(BounceRecords.from_rows(rec), g.T, n_tri, cfg.reference_quirks)


def grad_tile_plain(materials, scene, cfg, p, d, alive, g, uniforms=None, orig=None,
                    keys=None) -> torch.Tensor:
    """B2's plain version: the records of render_tile_plain, then the suffix
    recursion."""
    with torch.no_grad():
        _, _, rec = render_tile_rec_plain(materials, scene, cfg, p, d, alive, uniforms, orig,
                                          keys)
    return reverse_tile_plain(scene.n_tri, cfg, rec, g)

"""Wrappers of the render kernels and their plain PyTorch versions.

    render_tile / render_tile_plain          B1, the forward megakernel
    render_tile_rec / render_tile_rec_plain  B3, B1 that also writes records
    grad_tile / grad_tile_plain              B2, the fused backward (replay +
                                             suffix recursion)
    reverse_tile / reverse_tile_plain        B4, the suffix recursion on B3's
                                             records
    intersect_tile / intersect_tile_plain    B10, the clustered closest-hit
                                             sweep, launched on its own

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

On a clustered scene (ops/kernels/clusters.py) the kernels and the plain
versions work in the internal triangle order: the records' tri rows are
internal, and grad_tile, grad_tile_plain and reverse_tile(perm=...) map the
cotangent back to global rows.  Every B1-B9 kernel sweeps through B10
(render_common.cuh intersect); intersect_tile.launches counts each launch
that ran the clustered sweep, its own included.

Each wrapper launches its CUDA kernel (render_fwd.cu, render_bwd.cu) for
CUDA tensors and runs its plain version for CPU tensors; it never falls
back from one to the other on a CUDA tensor.  `<wrapper>.launches` counts
kernel launches.  B2 and B3 run persistent blocks whose lanes regenerate
(render_common.cuh warp_rays); `grad_tile.blocks` and
`render_tile_rec.blocks` hold the grid of their last launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.bsdf import INV_2PI, INV_PI, bsdf_from_values
from inverse_path_tracer_torch.ops.intersect import (
    Intersection,
    intersect_clustered,
    intersect_planes,
    plane_rows,
    smooth_normal,
)
from inverse_path_tracer_torch.ops.kernels.clusters import (
    KernelView,
    kernel_view,
    to_kernel_order,
    unperm_rows,
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
# nT * 3 floats of accumulators in at most 227 KB of shared memory; the
# internal (cluster-padded) triangle count is held to the same limit.
GRAD_MAX_BOUNCES = 64
GRAD_MAX_TRIANGLES = 2048
_BLOCK = 256  # threads per block of every kernel

# Staged-wavefront lane carry, (CARRY_ROWS, n) float32 rows (the JAX
# package's layout, ops/pallas/render_kernel.py:120-123): d 0:3, point 3:6,
# hit 6, idx 7 (internal triangle index as a float), l_e 8:11, l_d 11:14,
# prev_mult 14:17, alive 17, radiance 18:21, segments 21, shadow rays 22,
# pad 23.
CARRY_ROWS = 24
CAR_ALIVE, CAR_RAD, CAR_STATS = 17, slice(18, 21), slice(21, 23)


@dataclasses.dataclass
class KernelTables:
    """Device tables of the kernels (the counterpart of _pack_tables,
    render_kernel.py:1296, without the bf16 Kd split), in the kernels'
    triangle order."""

    planes: torch.Tensor  # (nT, 16) face plane + 3 edge planes
    table: torch.Tensor  # (nT, 16) emission, spec, shin, face_n, kd, pad
    vtab: Optional[torch.Tensor]  # (nT, 20) verts, vertex normals, area, pad
    etab: torch.Tensor  # (nE, 17|27) verts, emission, face_n, tri, p (+vn, area)
    cdf: torch.Tensor  # (nE,)
    no_spec: bool
    perm: Optional[torch.Tensor] = None  # internal -> global, None = global order
    cab: Optional[torch.Tensor] = None  # (C, 8) cluster boxes
    gab: Optional[torch.Tensor] = None  # (G, 8) boxes of the groups of clusters 1..
    cluster_k: int = 0  # 0 = dense sweep
    group: int = 0  # clusters per group box

    @property
    def padded_tri(self) -> int:
        """Triangles of the internal order rounded up to whole clusters."""
        n = self.planes.shape[0]
        return -(-n // self.cluster_k) * self.cluster_k if self.cluster_k else n


def pack_tables(scene: SceneData, materials: torch.Tensor, cfg=None) -> KernelTables:
    """The kernels' tables of `scene` with `materials`; with cfg, in the
    clustered order and with the cluster boxes where cfg clusters the scene
    (clusters.kernel_view), else dense in global order."""
    view = kernel_view(scene, cfg)
    s, materials = view.scene, to_kernel_order(materials, view)
    # flatten(1), not reshape(rows, -1): an emitter-free scene has 0 rows.
    f32 = lambda *xs: torch.cat([x.flatten(1).float() for x in xs], dim=1)
    table = f32(s.emission, s.specular, s.shininess[:, None], s.face_normal, materials,
                torch.zeros_like(materials))
    ei = s.emissive_idx
    ecols = [s.vertices[ei], s.emission[ei], s.face_normal[ei], ei.float()[:, None],
             s.emissive_p[:, None]]
    vtab = None
    if s.has_vertex_normals:
        vtab = f32(s.vertices, s.vertex_normals, s.area[:, None], torch.zeros_like(s.area)[:, None])
        ecols += [s.vertex_normals[ei], s.area[ei][:, None]]
    return KernelTables(
        planes=plane_rows(s),
        table=table.contiguous(),
        vtab=None if vtab is None else vtab.contiguous(),
        etab=f32(*ecols).contiguous(),
        cdf=s.emissive_cdf.float().contiguous(),
        no_spec=s.specular_idx.shape[0] == 0,
        perm=view.perm,
        cab=view.cab,
        gab=view.gab,
        cluster_k=view.cluster_k,
        group=view.group,
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


def _check_rng(p, uniforms, keys, rows):
    if (uniforms is None) == (keys is None):
        raise ValueError("pass exactly one of uniforms (external RNG) and keys (fused RNG)")
    if uniforms is not None:
        _check(p, {"uniforms": (uniforms, (rows, p.shape[1]), torch.float32)})


def _check_inputs(cfg, p, d, alive, uniforms, orig, keys):
    n = p.shape[1]
    _check(p, {"p": (p, (3, n), torch.float32), "d": (d, (3, n), torch.float32),
               "alive": (alive, (1, n), torch.float32), "orig": (orig, (1, n), torch.int32)})
    _check_rng(p, uniforms, keys, cfg.max_bounces * 8)


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
    materials, cfg), packed here when not given."""
    orig = _default_orig(p, orig)
    _check_inputs(cfg, p, d, alive, uniforms, orig, keys)
    if not _on_card(p, scene, materials):
        return render_tile_plain(materials, scene, cfg, p, d, alive, uniforms, orig, keys)
    lib = _library("render_fwd")
    params, tabs = _trace_params(materials, scene, cfg, tables, p, d, alive, uniforms, orig, keys)
    rad, stats = _fwd_outputs(p.shape[1], p.device)
    with torch.cuda.device(p.device):
        err = lib.ipt_render_fwd(ctypes.byref(params), rad.data_ptr(), stats.data_ptr(),
                                 torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, err, "render_fwd")
    render_tile.launches += 1
    _count_sweep(tabs)
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
    lib = _library("render_fwd")
    params, tabs = _trace_params(materials, scene, cfg, tables, p, d, alive, uniforms, orig, keys)
    n = p.shape[1]
    rad, stats = _fwd_outputs(n, p.device)
    rec = torch.empty((cfg.max_bounces * REC_ROWS, n), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        blocks = _blocks(lib, lib.ipt_render_rec_capacity, params, "render_fwd render_tile_rec")
        err = lib.ipt_render_rec(ctypes.byref(params), rad.data_ptr(), stats.data_ptr(),
                                 rec.data_ptr(), blocks,
                                 torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, err, "render_fwd render_tile_rec")
    render_tile_rec.launches += 1
    render_tile_rec.blocks = blocks
    _count_sweep(tabs)
    return rad, stats, rec


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
    """B2: d(sum g * radiance)/d materials (nT, 3), in global rows, for one
    range of rays, replaying the forward and running the suffix recursion
    in one kernel."""
    orig = _default_orig(p, orig)
    _check_inputs(cfg, p, d, alive, uniforms, orig, keys)
    _check(p, {"g": (g, (3, p.shape[1]), torch.float32)})
    if not _on_card(p, scene, materials):
        return grad_tile_plain(materials, scene, cfg, p, d, alive, g, uniforms, orig, keys)
    if cfg.max_bounces > GRAD_MAX_BOUNCES:
        raise ValueError(f"grad_tile keeps at most {GRAD_MAX_BOUNCES} bounces of records "
                         f"per thread, got max_bounces={cfg.max_bounces}")
    lib = _library("render_bwd")
    params, tabs = _trace_params(materials, scene, cfg, tables, p, d, alive, uniforms, orig, keys)
    _check_grad_triangles(tabs.padded_tri)
    with torch.cuda.device(p.device):
        blocks = _blocks(lib, lib.ipt_grad_tile_capacity, params, "render_bwd grad_tile")
        partials = torch.empty((blocks, scene.n_tri, 3), dtype=torch.float32, device=p.device)
        err = lib.ipt_grad_tile(ctypes.byref(params), g.data_ptr(), partials.data_ptr(), blocks,
                                torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, err, "render_bwd grad_tile")
    grad_tile.launches += 1
    grad_tile.blocks = blocks
    _count_sweep(tabs)
    return unperm_rows(partials.sum(dim=0), tabs.perm)


def reverse_tile(n_tri: int, cfg, rec: torch.Tensor, g: torch.Tensor,
                 perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B4: the material cotangent (nT, 3) from B3's records and g (3, n);
    `perm` (the tables' perm) maps internal rows back to global ones."""
    n = g.shape[1]
    _check(g, {"rec": (rec, (cfg.max_bounces * REC_ROWS, n), torch.float32),
               "g": (g, (3, n), torch.float32)})
    if g.device.type == "cpu":
        return reverse_tile_plain(n_tri, cfg, rec, g, perm)
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
    return unperm_rows(partials.sum(dim=0), perm)


def intersect_tile(
    scene: SceneData,
    cfg,
    p: torch.Tensor,
    d: torch.Tensor,
    *,
    tables: Optional[KernelTables] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10 on its own: the closest hit of each ray (3, n) through the
    kernels' sweep (clustered where cfg clusters the scene).  Returns t (n,)
    float32 (+inf on a miss) and the internal triangle index (n,) int32 (0
    on a miss)."""
    n = p.shape[1]
    _check(p, {"p": (p, (3, n), torch.float32), "d": (d, (3, n), torch.float32)})
    if not _on_card(p, scene):
        return intersect_tile_plain(scene, cfg, p, d)
    lib = _library("render_fwd")
    params, _ = _trace_params(scene.diffuse, scene, cfg, tables, p, d)
    t = torch.empty(n, dtype=torch.float32, device=p.device)
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        err = lib.ipt_intersect_tile(ctypes.byref(params), t.data_ptr(), idx.data_ptr(),
                                     torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, err, "render_fwd intersect_tile")
    intersect_tile.launches += 1
    return t, idx


render_tile.launches = 0
render_tile_rec.launches = 0
render_tile_rec.blocks = 0
grad_tile.launches = 0
grad_tile.blocks = 0
reverse_tile.launches = 0
intersect_tile.launches = 0


def _count_sweep(tabs: KernelTables) -> None:
    """One more launch of B10's code, if `tabs` are clustered."""
    if tabs.cluster_k:
        intersect_tile.launches += 1


class _TraceParams(ctypes.Structure):
    """render_common.cuh TraceParams, field for field."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("p", "d", "alive", "orig", "uniforms", "planes",
                                         "table", "vtab", "etab", "cdf", "cab", "gab")]
        + [("k0", ctypes.c_uint32), ("k1", ctypes.c_uint32)]
        + [(f, ctypes.c_int) for f in ("n", "n_tri", "n_emissive", "etab_stride", "has_vn",
                                        "no_spec", "quirks", "fused", "max_bounces",
                                        "use_smem", "cluster_k", "n_clusters",
                                        "cluster_group", "n_groups")]
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
        lib.ipt_render_fwd.argtypes = [params, vp, vp, vp]  # rad stats stream
        lib.ipt_render_fwd.restype = ci
        lib.ipt_render_rec_capacity.argtypes = [params, ctypes.POINTER(ci)]
        lib.ipt_render_rec_capacity.restype = ci
        # rad stats rec blocks stream
        lib.ipt_render_rec.argtypes = [params, vp, vp, vp, ci, vp]
        lib.ipt_render_rec.restype = ci
        lib.ipt_init_tile.argtypes = [params, vp, vp]  # carry stream
        lib.ipt_init_tile.restype = ci
        # carry_in carry_out rec start k live next stream
        lib.ipt_stage_tile.argtypes = [params, vp, vp, vp, ci, ci, vp, vp, vp]
        lib.ipt_stage_tile.restype = ci
        lib.ipt_intersect_tile.argtypes = [params, vp, vp, vp]  # t idx stream
        lib.ipt_intersect_tile.restype = ci
    elif name == "inverse":
        lib.ipt_inverse_grid_blocks.argtypes = [params, ctypes.POINTER(ci)]
        lib.ipt_inverse_grid_blocks.restype = ci
        # pix partials stats next_ray blocks stream
        lib.ipt_inverse_grid.argtypes = [params, vp, vp, vp, vp, ci, vp]
        lib.ipt_inverse_grid.restype = ci
        lib.ipt_inverse_rec.argtypes = [params, vp, vp, vp]  # rec stats stream
        lib.ipt_inverse_rec.restype = ci
        # pix grid stats next_ray stream
        lib.ipt_inverse_global.argtypes = [params, vp, vp, vp, vp, vp]
        lib.ipt_inverse_global.restype = ci
    else:
        lib.ipt_grad_tile_capacity.argtypes = [params, ctypes.POINTER(ci)]
        lib.ipt_grad_tile_capacity.restype = ci
        lib.ipt_grad_tile.argtypes = [params, vp, vp, ci, vp]  # g partials blocks stream
        lib.ipt_grad_tile.restype = ci
        # rec g n n_tri max_bounces quirks inv_pi partials stream
        lib.ipt_reverse_tile.argtypes = [vp, vp, ci, ci, ci, ci, cf, vp, vp]
        lib.ipt_reverse_tile.restype = ci
        # rec g suf_in n n_tri k quirks inv_pi partials suf_out stream
        lib.ipt_stage_reverse_tile.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf, vp, vp, vp]
        lib.ipt_stage_reverse_tile.restype = ci
    lib.ipt_error_string.argtypes = [ci]
    lib.ipt_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ipt_error_string(err).decode()}")


def _partials(n: int, n_tri: int, device) -> torch.Tensor:
    """One (nT, 3) partial sum per block of B4 or B9 (none for n = 0, where
    nothing is launched and the sum is zero)."""
    return torch.empty((-(-n // _BLOCK), n_tri, 3), dtype=torch.float32, device=device)


def persistent_blocks(n: int, capacity: int) -> int:
    """Blocks of a persistent launch for n rays: as many as fit on the card
    at once (`capacity`), at most one per block of rays (none for n = 0)."""
    return min(capacity, -(-n // _BLOCK))


def _blocks(lib, capacity_fn, params, what: str) -> int:
    """The persistent grid of B2 or B3 for the rays of `params`: the blocks
    that fit on the card at once (the kernel's occupancy; cached per device
    in the library), cut by persistent_blocks."""
    cap = ctypes.c_int(0)
    _raise_on(lib, capacity_fn(ctypes.byref(params), ctypes.byref(cap)), what)
    return persistent_blocks(params.n, cap.value)


def _fwd_outputs(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radiance (3, n) and per-lane counts (2, n) of B1 and B3."""
    return (torch.empty((3, n), dtype=torch.float32, device=device),
            torch.empty((2, n), dtype=torch.float32, device=device))


def _trace_params(materials, scene, cfg, tabs, p, d=None, alive=None, uniforms=None, orig=None,
                  keys=None):
    """The kernels' TraceParams (pointers into the caller's tensors, which
    must outlive the launch) and the tables they point to (packed here
    under cfg when `tabs` is None).  The lanes are p's columns."""
    if not (cfg.epsilon > 0 and cfg.min_dot > 0 and cfg.epsilon * cfg.min_dot >= 1e-30):
        # The range of render_common.cuh sweep()'s divide-free pre-test.
        raise ValueError("the kernels need epsilon > 0, min_dot > 0 and epsilon * min_dot >= "
                         f"1e-30, got epsilon {cfg.epsilon}, min_dot {cfg.min_dot}")
    if tabs is None:
        tabs = pack_tables(scene, materials, cfg)
    if tabs.planes.device != p.device:
        raise ValueError(f"tables are on {tabs.planes.device}, rays on {p.device}")
    ptr = lambda t: None if t is None else t.data_ptr()
    fused = keys is not None
    k0, k1 = keys if fused else (0, 0)
    ck = tabs.cluster_k
    params = _TraceParams(
        p=ptr(p), d=ptr(d), alive=ptr(alive), orig=ptr(orig), uniforms=ptr(uniforms),
        planes=ptr(tabs.planes), table=ptr(tabs.table), vtab=ptr(tabs.vtab),
        etab=ptr(tabs.etab), cdf=ptr(tabs.cdf), cab=ptr(tabs.cab), gab=ptr(tabs.gab),
        k0=k0, k1=k1,
        n=p.shape[1], n_tri=scene.n_tri, n_emissive=scene.n_emissive,
        etab_stride=tabs.etab.shape[1], has_vn=int(tabs.vtab is not None),
        no_spec=int(tabs.no_spec), quirks=int(cfg.reference_quirks), fused=int(fused),
        max_bounces=cfg.max_bounces, use_smem=0, cluster_k=ck,
        n_clusters=-(-scene.n_tri // ck) if ck else 0, cluster_group=tabs.group,
        n_groups=0 if tabs.gab is None else tabs.gab.shape[0], p_rr=cfg.p_rr, min_dot=cfg.min_dot,
        epsilon=cfg.epsilon, two_pi=TWO_PI, inv_pi=INV_PI, inv_2pi=INV_2PI,
        cos_scale=math.pi / cfg.p_rr, inv_p_rr=1.0 / cfg.p_rr,
    )
    return params, tabs


# --- The plain versions ---------------------------------------------------


def sweep(view: KernelView, cfg, o: torch.Tensor, dirs: torch.Tensor) -> Intersection:
    """The kernels' closest hit (rays (R, 3)) on the view: the clustered
    sweep on clustered views, else the dense one."""
    planes = plane_rows(view.scene)
    if view.cluster_k:
        return intersect_clustered(planes, view.cab, view.gab, view.cluster_k, view.group, o, dirs,
                                   cfg.min_dot, cfg.epsilon)
    return intersect_planes(planes, o, dirs, cfg.min_dot, cfg.epsilon)


def _sweep_on(view, cfg, mask, o, dirs) -> Intersection:
    """sweep() of the lanes in `mask`; the others miss (point = o)."""
    n = o.shape[0]
    t = torch.full((n,), float("inf"), dtype=torch.float32, device=o.device)
    tri = torch.zeros(n, dtype=torch.int64, device=o.device)
    point, hit = o.clone(), torch.zeros(n, dtype=torch.bool, device=o.device)
    sel = torch.nonzero(mask).squeeze(1)
    if sel.numel():
        sub = sweep(view, cfg, o[sel], dirs[sel])
        t[sel], tri[sel], point[sel], hit[sel] = sub.t, sub.tri, sub.point, sub.hit
    return Intersection(t=t, tri=tri, point=point, hit=hit)


class Lanes(NamedTuple):
    """Per-lane state of the bounce loop, (n, ...) each: the rows of the
    carry (CARRY_ROWS) in the plain versions' form."""

    d: torch.Tensor  # (n, 3) current direction
    point: torch.Tensor  # (n, 3) pending hit point
    hit: torch.Tensor  # (n,) bool: the pending ray hit
    idx: torch.Tensor  # (n,) int64 internal triangle of the pending hit (0 on a miss)
    l_e: torch.Tensor  # (n, 3)
    l_d: torch.Tensor  # (n, 3)
    pm: torch.Tensor  # (n, 3) throughput
    alive: torch.Tensor  # (n,) bool
    rad: torch.Tensor  # (n, 3)
    segs: torch.Tensor  # (n,)
    shadows: torch.Tensor  # (n,)

    def to_carry(self) -> torch.Tensor:
        f = lambda x: x.float()[None]
        return torch.cat([self.d.T, self.point.T, f(self.hit), f(self.idx), self.l_e.T,
                          self.l_d.T, self.pm.T, f(self.alive), self.rad.T, self.segs[None],
                          self.shadows[None], torch.zeros_like(self.segs)[None]]).contiguous()

    @classmethod
    def from_carry(cls, c: torch.Tensor) -> "Lanes":
        v = lambda lo: c[lo : lo + 3].T
        return cls(d=v(0), point=v(3), hit=c[6] > 0, idx=c[7].long(), l_e=v(8), l_d=v(11),
                   pm=v(14), alive=c[CAR_ALIVE] > 0, rad=v(18), segs=c[21], shadows=c[22])


def init_lanes(view: KernelView, cfg, p, d, alive) -> Lanes:
    """The bounce-0 intersection of every live lane (B7's plain version);
    dead lanes keep a miss at point 0, as in the kernels."""
    dirs = d.T.contiguous()
    live = alive[0] > 0
    cur = _sweep_on(view, cfg, live, p.T.contiguous(), dirs)
    zero3 = torch.zeros_like(dirs)
    zero = torch.zeros_like(dirs[:, 0])
    return Lanes(d=dirs, point=torch.where(live[:, None], cur.point, zero3), hit=cur.hit,
                 idx=cur.tri, l_e=zero3, l_d=zero3, pm=torch.ones_like(dirs), alive=live,
                 rad=zero3, segs=zero, shadows=zero)


def run_bounces(view: KernelView, materials, cfg, lanes: Lanes, orig, start: int, k: int,
                uniforms=None, keys=None, with_records=False):
    """At most k bounces of every live lane from global bounce `start`
    (ending at cfg.max_bounces): the bounce step of the JAX XLA path
    (render/forward.py:232-350) over all lanes at once, with the next
    ray's intersection fused behind the shadow ray as in the kernels.  A
    lane that dies keeps its state, as a kernel thread that stops does.
    `materials` are in the view's order; uniforms (k*8, n) are indexed by
    the local bounce, the fused RNG by the global one.  Returns the lanes
    and, with_records, the records (k*16, n), zero past a ray's last
    bounce (render/diff.py REC_ROWS).  Differentiable in `materials`."""
    scene = view.scene
    d, point, hit, idx, l_e, l_d, pm, live, rad, segs, shadows = lanes
    n = d.shape[0]
    quirks = cfg.reference_quirks
    no_spec = scene.specular_idx.shape[0] == 0
    h_orig = rng.hash_orig(keys, orig[0]) if keys is not None else None
    zero3 = torch.zeros_like(d)
    rec = (torch.zeros((k * REC_ROWS, n), dtype=torch.float32, device=d.device)
           if with_records else None)

    def masked(x, m):
        return torch.where(m.reshape(-1, *([1] * (x.dim() - 1))), x, torch.zeros_like(x))

    for bl in range(k):
        b = start + bl
        if b >= cfg.max_bounces or not bool(live.any()):
            break
        u = rng.draw(keys, h_orig, b, range(6)) if keys is not None else uniforms[8 * bl : 8 * bl + 6]
        hit_act = live & hit
        tri = idx
        emission = masked(scene.emission[tri], hit)
        spec = masked(scene.specular[tri], hit)
        shin = masked(scene.shininess[tri], hit)
        face_n = masked(scene.face_normal[tri], hit)
        kd = masked(materials[tri], hit)
        shade_n = masked(smooth_normal(scene, tri, point), hit)
        first_hit = hit_act & (b == 0)
        l_e = torch.where(hit_act[:, None],
                          torch.where(first_hit[:, None], emission, l_e if quirks else zero3), l_e)

        cont = hit_act & (u[3] < cfg.p_rr)
        is_spec = None if no_spec else ((spec != 0).any(dim=-1) & (shin != 0))
        next_dir, pdf = sample_next_dir(face_n, is_spec, shin, u[4], u[5])
        cosine = dot3(next_dir, shade_n)

        if scene.n_emissive > 0:
            e_tri, e_p = pick_emissive(scene, u[0])
            to_light = normalize3(sample_emissive_point(scene, e_tri, u[1], u[2]) - point)
            cos_theta = dot3(shade_n, to_light)
            sh = _sweep_on(view, cfg, hit_act, point, to_light)
            light_n = smooth_normal(scene, e_tri, sh.point)
            cos_theta_p = -dot3(light_n, to_light)
            ok = (cos_theta >= 0) & sh.hit & (cos_theta_p >= 0) & (sh.tri == e_tri)
            st = torch.where(ok, sh.t, torch.ones_like(sh.t))
            geo = cos_theta * cos_theta_p / st**2 / e_p
            bsdf_direct = kd if no_spec else bsdf_from_values(kd, spec, shin, shade_n, d, to_light,
                                                              True)
            nee = masked(scene.emission[e_tri] * geo[:, None], ok)
            l_d_fresh = masked(bsdf_direct * nee, ok)
            shadows = shadows + hit_act.float()
        else:
            nee = l_d_fresh = zero3
        nxt = _sweep_on(view, cfg, cont, point, next_dir)
        l_d = torch.where(hit_act[:, None], l_d_fresh, l_d)
        contrib_mask = live if quirks else hit_act
        c = masked(l_e + l_d, contrib_mask)
        rad = rad + masked(pm * c, contrib_mask)
        segs = segs + live.float()

        if no_spec:
            bsdf = kd * INV_PI
            coeff = cosine * (math.pi / cfg.p_rr)
        else:
            bsdf = bsdf_from_values(kd, spec, shin, shade_n, d, next_dir, False)
            coeff = torch.where(pdf > 0, cosine / pdf * (1.0 / cfg.p_rr),
                                torch.zeros_like(cosine))
        f = bsdf * coeff[:, None]
        if with_records:
            rows = [masked(f, cont).T, c.T, masked(nee, hit_act).T, masked(pm, live).T,
                    masked(coeff, cont)[None], masked(tri, hit_act).float()[None],
                    hit_act.float()[None], (live & ~hit).float()[None]]
            rec[bl * REC_ROWS : (bl + 1) * REC_ROWS] = torch.cat(rows).detach()
        pm = torch.where(cont[:, None], pm * f, pm)
        d = torch.where(cont[:, None], next_dir, d)
        point = torch.where(cont[:, None], nxt.point, point)
        hit = torch.where(cont, nxt.hit, hit)
        idx = torch.where(cont, nxt.tri, idx)
        live = cont

    return Lanes(d, point, hit, idx, l_e, l_d, pm, live, rad, segs, shadows), rec


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
    """The same function in plain PyTorch on any device: init_lanes, then
    run_bounces over all max_bounces bounces.  Differentiable in
    `materials` by torch autograd.

    with_records=True also returns the records (max_bounces*16, n) of
    render/diff.py REC_ROWS, as the JAX _bounce_step does with its
    with_records flag (forward.py:339-349); slots past a ray's last bounce
    are zero, tri rows internal on clustered scenes."""
    orig = _default_orig(p, orig)
    _check_inputs(cfg, p, d, alive, uniforms, orig, keys)
    view = kernel_view(scene, cfg)
    lanes = init_lanes(view, cfg, p, d, alive)
    lanes, rec = run_bounces(view, to_kernel_order(materials, view), cfg, lanes, orig, 0,
                             cfg.max_bounces, uniforms, keys, with_records)
    stats = torch.stack([lanes.segs, lanes.shadows], dim=0)
    if with_records:
        return lanes.rad.T.contiguous(), stats, rec
    return lanes.rad.T.contiguous(), stats


def render_tile_rec_plain(materials, scene, cfg, p, d, alive, uniforms=None, orig=None,
                          keys=None):
    """B3's plain version: render_tile_plain with records."""
    return render_tile_plain(materials, scene, cfg, p, d, alive, uniforms, orig, keys,
                             with_records=True)


def reverse_tile_plain(n_tri: int, cfg, rec: torch.Tensor, g: torch.Tensor,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B4's plain version: render/diff.py backward_from_records on the rows,
    mapped back to global rows with `perm`."""
    d_mats = backward_from_records(BounceRecords.from_rows(rec), g.T, n_tri,
                                   cfg.reference_quirks)
    return unperm_rows(d_mats, perm)


def grad_tile_plain(materials, scene, cfg, p, d, alive, g, uniforms=None, orig=None,
                    keys=None) -> torch.Tensor:
    """B2's plain version: the records of render_tile_plain, then the suffix
    recursion, in global rows."""
    with torch.no_grad():
        _, _, rec = render_tile_rec_plain(materials, scene, cfg, p, d, alive, uniforms, orig,
                                          keys)
    return reverse_tile_plain(scene.n_tri, cfg, rec, g, kernel_view(scene, cfg).perm)


def intersect_tile_plain(scene: SceneData, cfg, p: torch.Tensor, d: torch.Tensor):
    """B10's plain version: ops/intersect.py intersect_clustered on the
    kernels' view (the dense sweep on scenes cfg does not cluster)."""
    hit = sweep(kernel_view(scene, cfg), cfg, p.T.contiguous(), d.T.contiguous())
    return hit.t, hit.tri.to(torch.int32)

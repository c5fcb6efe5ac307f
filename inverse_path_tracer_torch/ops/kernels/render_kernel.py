"""Wrappers of the render kernels and their plain PyTorch versions.

    render_tile / render_tile_plain          B1, the forward megakernel
    render_tile_rec / render_tile_rec_plain  B3, B1 that also writes records
    grad_tile / grad_tile_plain              B2, the fused backward (replay +
                                             suffix recursion)
    reverse_tile / reverse_tile_plain        B4, the suffix recursion on B3's
                                             records
    intersect_tile / intersect_tile_plain    B10, the clustered closest-hit
                                             sweep, or the BVH traversal,
                                             launched on its own

They take the arguments and return the outputs of the JAX package's
render_tile_pallas, render_tile_pallas_rec, grad_tile_pallas and
reverse_tile_pallas (ops/pallas/render_kernel.py:1440, :1571, :1505, :1640):

    p, d      (3, n) float32 ray origins / directions
    alive     (1, n) float32 0/1 initial alive mask
    orig      (1, n) int32 global sample indices (the fused RNG's counter)
    camera    in place of p, d, alive and orig: ops/camera.py Camera(base,
              n, key), the primary rays of global samples base .. base+n-1,
              which the kernels make themselves (the fused paths' mode; it
              needs keys); the plain versions make them with camera_rays
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
that ran the clustered sweep, its own included.  On the BVH route
(cfg.intersect="bvh" on a scene with a BVH; clusters.uses_bvh) the
internal order is the tree's leaf order, B1, B2, B3 and intersect_tile
search through the traversal (render_common.cuh traverse) and the plain
versions through ops/bvh.py intersect_bvh; bvh_traversal.launches counts
each launch that ran the traversal.  B7 and B8 do not take that route.

Each wrapper launches its CUDA kernel (render_fwd.cu, render_bwd.cu) for
CUDA tensors (in camera mode: for a scene on the card) and runs its plain
version for CPU tensors; it never falls back from one to the other on a
CUDA tensor.  `<wrapper>.launches` counts kernel launches; each call runs
under the span ipt.launch.<wrapper> (utils/profiling.py).  B1, B2 and B3
run persistent blocks whose lanes regenerate (render_common.cuh
warp_rays); `render_tile.blocks`, `grad_tile.blocks`,
`render_tile_rec.blocks` and `reverse_tile.blocks` hold the grid of their
last launch.  The gradient kernels keep one (nT, 3) row of accumulators per
warp, in shared memory or in a scratch buffer in global memory that the
wrappers allocate (render_bwd.cu header; acc_scratch), so that they take
any triangle count: B4, B9 and the clustered B2 where a block's rows do not
fit in shared memory, the dense and BVH B2 wherever the rows would hold the
kernel below the blocks per SM that its registers allow (the BVH instance
from ~1,200 triangles).  Traced, grad_tile counts the floats each launch
keeps there (ipt.grad.scratch_floats: blocks times the floats a block
needs; 0 where the rows are in shared memory).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import types
from typing import NamedTuple, Optional, Tuple

import torch

from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.bsdf import INV_2PI, INV_PI, bsdf_from_values
from inverse_path_tracer_torch.ops.bvh import intersect_bvh, node_rows
from inverse_path_tracer_torch.ops.camera import Camera, camera_inputs
from inverse_path_tracer_torch.ops.intersect import (
    Intersection,
    counting_sweeps,
    intersect_clustered,
    intersect_planes,
    plane_rows,
    smooth_normal,
)
from inverse_path_tracer_torch.ops.kernels.clusters import (
    MAX_CLUSTER_GROUP,
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
from inverse_path_tracer_torch.utils.profiling import count, span, spanned

Keys = Tuple[int, int]

# render_bwd.cu: records of at most 64 bounces per thread.
GRAD_MAX_BOUNCES = 64
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
    cam: Optional[torch.Tensor] = None  # (3, 3) camera matrix (camera mode's rays)
    nodes: Optional[torch.Tensor] = None  # (1 + inner nodes, 16) BVH rows (ops/bvh.py node_rows)
    tri_index: Optional[torch.Tensor] = None  # (nT,) int32 global index of each row

    @property
    def padded_tri(self) -> int:
        """Triangles of the internal order rounded up to whole clusters."""
        n = self.planes.shape[0]
        return -(-n // self.cluster_k) * self.cluster_k if self.cluster_k else n


@spanned("ipt.prep.tables")
def pack_tables(scene: SceneData, materials: torch.Tensor, cfg=None) -> KernelTables:
    """The kernels' tables of `scene` with `materials`; with cfg, in the
    clustered order and with the cluster boxes where cfg clusters the scene,
    or in the BVH's leaf order with its node table on the BVH route
    (clusters.kernel_view; the tree was checked where it entered the port,
    ops/bvh.py check_bvh), else dense in global order.  The BVH route's
    own work, the leaf-order view, the node table and tri_index, runs
    under the span ipt.prep.bvh."""
    view = kernel_view(scene, cfg)
    nodes = tri_index = None
    if view.bvh is not None:
        with span("ipt.prep.bvh"):
            nodes = node_rows(view.bvh).to(scene.device)
            tri_index = view.perm.to(torch.int32).contiguous()
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
        cam=s.cam_m33.float().contiguous(),
        nodes=nodes,
        tri_index=tri_index,
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


def _check_rays(p, d, alive, orig, camera) -> int:
    """Checks one launch's rays p, d, alive, orig (orig defaults to zeros)
    or, in camera mode, a Camera and none of them.  Returns the lane count
    n."""
    if camera is None:
        if p is None or d is None or alive is None:
            raise ValueError("pass the rays p, d and alive, or camera")
        n, orig = p.shape[1], _default_orig(p, orig)
        _check(p, {"p": (p, (3, n), torch.float32), "d": (d, (3, n), torch.float32),
                   "alive": (alive, (1, n), torch.float32),
                   "orig": (orig, (1, n), torch.int32)})
        return n
    if any(t is not None for t in (p, d, alive, orig)):
        raise ValueError("camera replaces p, d, alive and orig")
    if camera.n < 0 or camera.base < 0:
        raise ValueError(f"bad camera launch {camera}")
    return camera.n


def _check_launch(cfg, scene, p, d, alive, uniforms, orig, keys, camera) -> int:
    """Checks one launch's ray inputs (_check_rays) and its RNG: uniforms
    or keys with the rays, the fused RNG's keys in camera mode.  Returns
    the lane count n."""
    n = _check_rays(p, d, alive, orig, camera)
    if camera is None:
        _check_rng(p, uniforms, keys, cfg.max_bounces * 8)
    elif uniforms is not None:
        raise ValueError("camera replaces uniforms: pass the fused RNG's keys")
    elif keys is None:
        raise ValueError("camera mode needs the fused RNG's keys")
    return n


def _on_card(p, scene, materials=None) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise.  In
    camera mode (p None) the scene's device decides."""
    if p is None:
        p = scene.vertices
    if p.device.type == "cpu":
        return False
    if p.device.type != "cuda":
        raise ValueError(f"the render kernels run on CUDA or CPU tensors, got {p.device}")
    if scene.device != p.device or (materials is not None and materials.device != p.device):
        raise ValueError(f"scene/materials must be on {p.device}")
    return True


def _default_orig(p, orig):
    if orig is None and p is not None:
        return torch.zeros((1, p.shape[1]), dtype=torch.int32, device=p.device)
    return orig


def _ray_inputs(scene, cfg, p, d, alive, orig, camera):
    """The plain versions' rays: as given, or made from `camera` by the
    plain camera_rays (ops/camera.py camera_inputs)."""
    if camera is None:
        return p, d, alive, _default_orig(p, orig)
    a = camera_inputs(scene, cfg, camera)
    return a["p"], a["d"], a["alive"], a["orig"]


@spanned("ipt.launch.render_tile")
def render_tile(
    materials: torch.Tensor,
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
    """B1: render one range of rays.  `tables` is pack_tables(scene,
    materials, cfg), packed here when not given."""
    n = _check_launch(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    if not _on_card(p, scene, materials):
        return render_tile_plain(materials, scene, cfg, p, d, alive, uniforms, orig, keys,
                                 camera=camera)
    lib = _library("render_fwd")
    dev = scene.device
    params, tabs = _trace_params(materials, scene, cfg, tables, p, d, alive, uniforms,
                                 _default_orig(p, orig), keys, camera)
    rad, stats = _fwd_outputs(n, dev)
    with torch.cuda.device(dev):
        blocks = _blocks(lib, lambda pr, cap: lib.ipt_render_capacity(pr, 0, cap), params,
                         "render_fwd render_tile")
        err = lib.ipt_render_fwd(ctypes.byref(params), rad.data_ptr(), stats.data_ptr(), blocks,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "render_fwd")
    render_tile.launches += 1
    render_tile.blocks = blocks
    _count_sweep(tabs)
    return rad, stats


@spanned("ipt.launch.render_tile_rec")
def render_tile_rec(
    materials: torch.Tensor,
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3: render_tile that also returns the records (max_bounces*16, n)."""
    n = _check_launch(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    if not _on_card(p, scene, materials):
        return render_tile_rec_plain(materials, scene, cfg, p, d, alive, uniforms, orig, keys,
                                     camera=camera)
    lib = _library("render_fwd")
    dev = scene.device
    params, tabs = _trace_params(materials, scene, cfg, tables, p, d, alive, uniforms,
                                 _default_orig(p, orig), keys, camera)
    rad, stats = _fwd_outputs(n, dev)
    rec = torch.empty((cfg.max_bounces * REC_ROWS, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        blocks = _blocks(lib, lambda pr, cap: lib.ipt_render_capacity(pr, 1, cap), params,
                         "render_fwd render_tile_rec")
        err = lib.ipt_render_rec(ctypes.byref(params), rad.data_ptr(), stats.data_ptr(),
                                 rec.data_ptr(), blocks,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "render_fwd render_tile_rec")
    render_tile_rec.launches += 1
    render_tile_rec.blocks = blocks
    _count_sweep(tabs)
    return rad, stats, rec


@spanned("ipt.launch.grad_tile")
def grad_tile(
    materials: torch.Tensor,
    scene: SceneData,
    cfg,
    p: Optional[torch.Tensor] = None,
    d: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    g: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    orig: Optional[torch.Tensor] = None,
    keys: Optional[Keys] = None,
    *,
    camera: Optional[Camera] = None,
    tables: Optional[KernelTables] = None,
) -> torch.Tensor:
    """B2: d(sum g * radiance)/d materials (nT, 3), in global rows, for one
    range of rays, replaying the forward and running the suffix recursion
    in one kernel.  g (3, n) is required."""
    n = _check_launch(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    if g is None:
        raise ValueError("grad_tile needs the radiance cotangent g (3, n)")
    _check(g, {"g": (g, (3, n), torch.float32)})
    if not _on_card(p, scene, materials):
        return grad_tile_plain(materials, scene, cfg, p, d, alive, g, uniforms, orig, keys,
                               camera=camera)
    if g.device != scene.device:
        raise ValueError(f"g is on {g.device}, the scene on {scene.device}")
    if cfg.max_bounces > GRAD_MAX_BOUNCES:
        raise ValueError(f"grad_tile keeps at most {GRAD_MAX_BOUNCES} bounces of records "
                         f"per thread, got max_bounces={cfg.max_bounces}")
    lib = _library("render_bwd")
    dev = scene.device
    params, tabs = _trace_params(materials, scene, cfg, tables, p, d, alive, uniforms,
                                 _default_orig(p, orig), keys, camera)
    with torch.cuda.device(dev):
        cap, per_block = ctypes.c_int(0), ctypes.c_longlong(0)
        _raise_on(lib, lib.ipt_grad_tile_capacity(ctypes.byref(params), ctypes.byref(cap),
                                                  ctypes.byref(per_block)), "render_bwd grad_tile")
        blocks = persistent_blocks(params.n, cap.value)
        partials = torch.empty((blocks, scene.n_tri, 3), dtype=torch.float32, device=dev)
        scratch = acc_scratch(blocks, per_block.value, dev)
        err = lib.ipt_grad_tile(ctypes.byref(params), g.data_ptr(), partials.data_ptr(),
                                _ptr(scratch), blocks, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "render_bwd grad_tile")
    grad_tile.launches += 1
    grad_tile.blocks = blocks
    count("ipt.grad.scratch_floats", blocks * per_block.value)
    _count_sweep(tabs)
    return unperm_rows(partials.sum(dim=0), tabs.perm)


@spanned("ipt.launch.reverse_tile")
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
    lib = _library("render_bwd")
    with torch.cuda.device(g.device):
        blocks, per_block = ctypes.c_int(0), ctypes.c_longlong(0)
        _raise_on(lib, lib.ipt_reverse_tile_blocks(n, n_tri, ctypes.byref(blocks),
                                                   ctypes.byref(per_block)),
                  "render_bwd reverse_tile")
        partials = torch.empty((blocks.value, n_tri, 3), dtype=torch.float32, device=g.device)
        scratch = acc_scratch(blocks.value, per_block.value, g.device)
        err = lib.ipt_reverse_tile(rec.data_ptr(), g.data_ptr(), n, n_tri, cfg.max_bounces,
                                   int(cfg.reference_quirks), INV_PI, partials.data_ptr(),
                                   _ptr(scratch), blocks.value,
                                   torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(lib, err, "render_bwd reverse_tile")
    reverse_tile.launches += 1
    reverse_tile.blocks = blocks.value
    return unperm_rows(partials.sum(dim=0), perm)


@spanned("ipt.launch.intersect_tile")
def intersect_tile(
    scene: SceneData,
    cfg,
    p: torch.Tensor,
    d: torch.Tensor,
    *,
    tables: Optional[KernelTables] = None,
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10 on its own: the closest hit of each ray (3, n) through the
    kernels' sweep (clustered where cfg clusters the scene), or through the
    BVH traversal on the BVH route.  Returns t (n,) float32 (+inf on a miss)
    and the internal triangle index (n,) int32 (0 on a miss).  `counts`, an
    int64 tensor on the rays' device, gains the search's work: on the BVH
    route (4,), the traversal's nodes visited, (ray, box) tests, (ray,
    triangle) tests and visits culled by their stored entry distance (each
    a row load and a box test that the pop skips); on clustered tables
    (4,), the (ray, group) box tests,
    the (ray, cluster) box tests, the (ray, triangle) pairs and the pair
    loop's lane-slots, 32 a row of each pass of a warp (render_common.cuh
    SweepWork).  The dense sweep counts nothing."""
    n = p.shape[1]
    _check(p, {"p": (p, (3, n), torch.float32), "d": (d, (3, n), torch.float32)})
    if not _on_card(p, scene):
        return intersect_tile_plain(scene, cfg, p, d, counts=counts)
    lib = _library("render_fwd")
    params, tabs = _trace_params(scene.diffuse, scene, cfg, tables, p, d)
    if counts is not None:
        _check(p, {"counts": (counts, (_count_width(tabs.nodes is not None, tabs.cluster_k),),
                              torch.int64)})
    t = torch.empty(n, dtype=torch.float32, device=p.device)
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        err = lib.ipt_intersect_tile(ctypes.byref(params), t.data_ptr(), idx.data_ptr(),
                                     _ptr(counts), torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, err, "render_fwd intersect_tile")
    if tabs.nodes is not None:
        bvh_traversal.launches += 1
    else:
        intersect_tile.launches += 1
    return t, idx


render_tile.launches = 0
render_tile.blocks = 0
render_tile_rec.launches = 0
render_tile_rec.blocks = 0
grad_tile.launches = 0
grad_tile.blocks = 0
reverse_tile.launches = 0
reverse_tile.blocks = 0
intersect_tile.launches = 0
# Launches that ran the BVH traversal (B1, B2, B3 or intersect_tile on BVH
# tables), as intersect_tile.launches counts B10's.
bvh_traversal = types.SimpleNamespace(launches=0)


def _refuse_bvh(tabs: KernelTables, what: str) -> None:
    """Raises where `tabs` are BVH tables: the kernel `what` has no BVH
    flavour and would sweep their leaf-order rows, breaking exact ties by
    row instead of by global index."""
    if tabs.nodes is not None:
        raise ValueError(f"{what} does not take the BVH route: pass tables and a config off it "
                         "(B1, B2, B3 and intersect_tile traverse the BVH)")


def _count_sweep(tabs: KernelTables) -> None:
    """One more launch of B10's code, if `tabs` are clustered, or of the
    BVH traversal, on BVH tables."""
    if tabs.cluster_k:
        intersect_tile.launches += 1
    elif tabs.nodes is not None:
        bvh_traversal.launches += 1


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
        + [("base", ctypes.c_longlong), ("n_samples", ctypes.c_longlong),
           ("cam", ctypes.c_void_p)]
        + [(f, ctypes.c_int) for f in ("camera", "width", "height", "spp")]
        + [("ck0", ctypes.c_uint32), ("ck1", ctypes.c_uint32)]
        + [("nodes", ctypes.c_void_p), ("tri_index", ctypes.c_void_p), ("n_nodes", ctypes.c_int)]
    )


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """The named kernel library (built on first use), with its C signatures."""
    from inverse_path_tracer_torch.ops.kernels.build import load

    lib = load(name)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    params = ctypes.POINTER(_TraceParams)
    if name == "render_fwd":
        lib.ipt_render_capacity.argtypes = [params, ci, ctypes.POINTER(ci)]  # records blocks
        lib.ipt_render_capacity.restype = ci
        lib.ipt_render_fwd.argtypes = [params, vp, vp, ci, vp]  # rad stats blocks stream
        lib.ipt_render_fwd.restype = ci
        # rad stats rec blocks stream
        lib.ipt_render_rec.argtypes = [params, vp, vp, vp, ci, vp]
        lib.ipt_render_rec.restype = ci
        lib.ipt_init_blocks.argtypes = [params, ctypes.POINTER(ci)]  # blocks
        lib.ipt_init_blocks.restype = ci
        lib.ipt_init_tile.argtypes = [params, vp, ci, vp]  # carry blocks stream
        lib.ipt_init_tile.restype = ci
        # carry_in carry_out rec start k live next stream
        lib.ipt_stage_tile.argtypes = [params, vp, vp, vp, ci, ci, vp, vp, vp]
        lib.ipt_stage_tile.restype = ci
        lib.ipt_intersect_tile.argtypes = [params, vp, vp, vp, vp]  # t idx counts stream
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
    elif name == "reorder":
        pll = ctypes.POINTER(ctypes.c_longlong)
        lib.ipt_reorder_sizes.argtypes = [ci, ci, ci, pll, pll]  # n binned cells table counts
        lib.ipt_reorder_sizes.restype = ci
        # carry_in orig_in n lo inv_ext cells keys table counts carry_out orig_out order live stream
        lib.ipt_reorder_tile.argtypes = [vp, vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.ipt_reorder_tile.restype = ci
    else:
        pi, pll = ctypes.POINTER(ci), ctypes.POINTER(ctypes.c_longlong)
        lib.ipt_grad_tile_capacity.argtypes = [params, pi, pll]  # blocks scratch
        lib.ipt_grad_tile_capacity.restype = ci
        # g partials scratch blocks stream
        lib.ipt_grad_tile.argtypes = [params, vp, vp, vp, ci, vp]
        lib.ipt_grad_tile.restype = ci
        lib.ipt_reverse_tile_blocks.argtypes = [ci, ci, pi, pll]  # n n_tri blocks scratch
        lib.ipt_reverse_tile_blocks.restype = ci
        # rec g n n_tri max_bounces quirks inv_pi partials scratch blocks stream
        lib.ipt_reverse_tile.argtypes = [vp, vp, ci, ci, ci, ci, cf, vp, vp, ci, vp]
        lib.ipt_reverse_tile.restype = ci
        # n n_tri k blocks scratch
        lib.ipt_stage_reverse_blocks.argtypes = [ci, ci, ci, pi, pll]
        lib.ipt_stage_reverse_blocks.restype = ci
        # rec g suf_in n n_tri k quirks inv_pi partials suf_out scratch blocks stream
        lib.ipt_stage_reverse_tile.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf, vp, vp, vp, ci, vp]
        lib.ipt_stage_reverse_tile.restype = ci
    lib.ipt_error_string.argtypes = [ci]
    lib.ipt_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ipt_error_string(err).decode()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def acc_scratch(blocks: int, per_block: int, device) -> Optional[torch.Tensor]:
    """The scratch buffer of a gradient kernel's accumulators in global
    memory (render_bwd.cu header): blocks * per_block floats, None where the
    library gives 0 floats per block (they fit in shared memory)."""
    if per_block == 0:
        return None
    return torch.empty(blocks * per_block, dtype=torch.float32, device=device)


def persistent_blocks(n: int, capacity: int, block: int = _BLOCK) -> int:
    """Blocks of a persistent launch for n rays: as many as fit on the card
    at once (`capacity`), at most one per `block` rays (none for n = 0)."""
    return min(capacity, -(-n // block))


def _blocks(lib, capacity_fn, params, what: str) -> int:
    """The persistent grid of B1 or B3 for the rays of `params`: the blocks
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
                  keys=None, camera: Optional[Camera] = None):
    """The kernels' TraceParams (pointers into the caller's tensors, which
    must outlive the launch) and the tables they point to (packed here
    under cfg when `tabs` is None).  The lanes are p's columns, or in camera
    mode the samples of `camera`."""
    if not (cfg.epsilon > 0 and cfg.min_dot > 0 and cfg.epsilon * cfg.min_dot >= 1e-30):
        # The range of render_common.cuh sweep()'s divide-free pre-test.
        raise ValueError("the kernels need epsilon > 0, min_dot > 0 and epsilon * min_dot >= "
                         f"1e-30, got epsilon {cfg.epsilon}, min_dot {cfg.min_dot}")
    if tabs is None:
        tabs = pack_tables(scene, materials, cfg)
    if tabs.cluster_k and tabs.group > MAX_CLUSTER_GROUP:
        raise ValueError(f"the kernels take at most {MAX_CLUSTER_GROUP} clusters a group, got "
                         f"{tabs.group}")
    dev = scene.device if p is None else p.device
    if tabs.planes.device != dev:
        raise ValueError(f"tables are on {tabs.planes.device}, rays on {dev}")
    fused = keys is not None
    k0, k1 = keys if fused else (0, 0)
    ck0, ck1 = rng.key_words(camera.key) if camera is not None else (0, 0)
    ck = tabs.cluster_k
    params = _TraceParams(
        p=_ptr(p), d=_ptr(d), alive=_ptr(alive), orig=_ptr(orig), uniforms=_ptr(uniforms),
        planes=_ptr(tabs.planes), table=_ptr(tabs.table), vtab=_ptr(tabs.vtab),
        etab=_ptr(tabs.etab), cdf=_ptr(tabs.cdf), cab=_ptr(tabs.cab), gab=_ptr(tabs.gab),
        k0=k0, k1=k1,
        n=camera.n if camera is not None else p.shape[1], n_tri=scene.n_tri,
        n_emissive=scene.n_emissive,
        etab_stride=tabs.etab.shape[1], has_vn=int(tabs.vtab is not None),
        no_spec=int(tabs.no_spec), quirks=int(cfg.reference_quirks), fused=int(fused),
        max_bounces=cfg.max_bounces, use_smem=0, cluster_k=ck,
        n_clusters=-(-scene.n_tri // ck) if ck else 0, cluster_group=tabs.group,
        n_groups=0 if tabs.gab is None else tabs.gab.shape[0], p_rr=cfg.p_rr, min_dot=cfg.min_dot,
        epsilon=cfg.epsilon, two_pi=TWO_PI, inv_pi=INV_PI, inv_2pi=INV_2PI,
        cos_scale=math.pi / cfg.p_rr, inv_p_rr=1.0 / cfg.p_rr,
        base=camera.base if camera is not None else 0, n_samples=cfg.n_samples,
        cam=_ptr(tabs.cam), camera=int(camera is not None), width=cfg.width,
        height=cfg.height, spp=cfg.spp, ck0=ck0, ck1=ck1, nodes=_ptr(tabs.nodes),
        tri_index=_ptr(tabs.tri_index), n_nodes=0 if tabs.nodes is None else tabs.nodes.shape[0],
    )
    return params, tabs


# --- The plain versions ---------------------------------------------------


def sweep(view: KernelView, cfg, o: torch.Tensor, dirs: torch.Tensor) -> Intersection:
    """The kernels' closest hit (rays (R, 3)) on the view: on the BVH
    route ops/bvh.py intersect_bvh on the scene in global order, its
    triangle mapped to the view's row; the clustered sweep on clustered
    views, else the dense one."""
    if view.bvh is not None:
        hit = intersect_bvh(view.source, view.bvh, o, dirs, cfg.min_dot, cfg.epsilon)
        row = torch.empty_like(view.perm)
        row[view.perm] = torch.arange(view.perm.shape[0], device=view.perm.device)
        return hit._replace(tri=torch.where(hit.hit, row[hit.tri], torch.zeros_like(hit.tri)))
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
    p: Optional[torch.Tensor] = None,
    d: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    orig: Optional[torch.Tensor] = None,
    keys: Optional[Keys] = None,
    with_records: bool = False,
    *,
    camera: Optional[Camera] = None,
):
    """The same function in plain PyTorch on any device: init_lanes, then
    run_bounces over all max_bounces bounces.  Differentiable in
    `materials` by torch autograd.  In camera mode the rays are the plain
    camera_rays' (ops/camera.py camera_inputs).

    with_records=True also returns the records (max_bounces*16, n) of
    render/diff.py REC_ROWS, as the JAX _bounce_step does with its
    with_records flag (forward.py:339-349); slots past a ray's last bounce
    are zero, tri rows internal on clustered scenes."""
    _check_launch(cfg, scene, p, d, alive, uniforms, orig, keys, camera)
    p, d, alive, orig = _ray_inputs(scene, cfg, p, d, alive, orig, camera)
    view = kernel_view(scene, cfg)
    lanes = init_lanes(view, cfg, p, d, alive)
    lanes, rec = run_bounces(view, to_kernel_order(materials, view), cfg, lanes, orig, 0,
                             cfg.max_bounces, uniforms, keys, with_records)
    stats = torch.stack([lanes.segs, lanes.shadows], dim=0)
    if with_records:
        return lanes.rad.T.contiguous(), stats, rec
    return lanes.rad.T.contiguous(), stats


def render_tile_rec_plain(materials, scene, cfg, p=None, d=None, alive=None, uniforms=None,
                          orig=None, keys=None, *, camera=None):
    """B3's plain version: render_tile_plain with records."""
    return render_tile_plain(materials, scene, cfg, p, d, alive, uniforms, orig, keys,
                             with_records=True, camera=camera)


def reverse_tile_plain(n_tri: int, cfg, rec: torch.Tensor, g: torch.Tensor,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B4's plain version: render/diff.py backward_from_records on the rows,
    mapped back to global rows with `perm`."""
    d_mats = backward_from_records(BounceRecords.from_rows(rec), g.T, n_tri,
                                   cfg.reference_quirks)
    return unperm_rows(d_mats, perm)


def grad_tile_plain(materials, scene, cfg, p=None, d=None, alive=None, g=None, uniforms=None,
                    orig=None, keys=None, *, camera=None) -> torch.Tensor:
    """B2's plain version: the records of render_tile_plain, then the suffix
    recursion, in global rows."""
    with torch.no_grad():
        _, _, rec = render_tile_rec_plain(materials, scene, cfg, p, d, alive, uniforms, orig,
                                          keys, camera=camera)
    return reverse_tile_plain(scene.n_tri, cfg, rec, g, kernel_view(scene, cfg).perm)


def _count_width(bvh: bool, cluster_k: int) -> int:
    """The length of intersect_tile's `counts`: 4 for the BVH traversal and
    for the clustered sweep."""
    if not (bvh or cluster_k):
        raise ValueError("counts are the BVH traversal's or the clustered sweep's: "
                         "the dense sweep counts nothing")
    return 4


def intersect_tile_plain(scene: SceneData, cfg, p: torch.Tensor, d: torch.Tensor,
                         counts: Optional[torch.Tensor] = None):
    """B10's plain version: ops/intersect.py intersect_clustered on the
    kernels' view (the dense sweep on scenes cfg does not cluster; on the
    BVH route ops/bvh.py intersect_bvh).  `counts` gains intersect_tile's
    counts on the BVH route; on clustered tables the per-lane loop's
    (counting_sweeps: its box tests, pairs and `loop_slots`), the least
    work of the sweep, of which the kernel's warp-cooperative schedule
    tests and sweeps as much or more."""
    view = kernel_view(scene, cfg)
    o, dirs = p.T.contiguous(), d.T.contiguous()
    if counts is None:
        hit = sweep(view, cfg, o, dirs)
    else:
        _check(p, {"counts": (counts, (_count_width(view.bvh is not None, view.cluster_k),),
                              torch.int64)})
        with counting_sweeps() as c:
            hit = sweep(view, cfg, o, dirs)
        keys = (("nodes", "node_tests", "tri_tests", "culled") if view.bvh is not None
                else ("group_tests", "tests", "pairs", "loop_slots"))
        counts += torch.tensor([c[k] for k in keys], device=counts.device)
    return hit.t, hit.tri.to(torch.int32)

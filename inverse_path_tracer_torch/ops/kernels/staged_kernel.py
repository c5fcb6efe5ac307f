"""Wrappers of the staged-wavefront kernels and their plain PyTorch
versions.

    init_tile / init_tile_plain                    B7, the bounce-0
                                                   intersection into the carry
    stage_tile / stage_tile_plain                  B8, at most k bounces of
                                                   every live lane of a carry
    stage_reverse_tile / stage_reverse_tile_plain  B9, the suffix recursion
                                                   over one stage's records

They take the arguments and return the outputs of the JAX package's
init_tile_pallas, stage_tile_pallas and stage_reverse_tile_pallas
(ops/pallas/render_kernel.py:1677, :1711, :1780):

    carry     (CARRY_ROWS, n) float32 lane carry (render_kernel.py CARRY_ROWS)
    orig      (1, n) int32 global sample index of each lane
    start, k  the stage's first global bounce and its bounce budget
    uniforms  (k*8, n) float32 rows of the stage's bounces (external RNG),
              or None; keys (k0, k1) for the fused RNG
    rec       (k*16, n) float32 records of a stage, zero past a lane's last
              bounce of the stage (render/diff.py REC_ROWS)
    g         (3, n) radiance cotangent, suf (4, n) the (suf, esc) carry of
              the later stages, both in the stage's lane order

B7 takes the rays p, d (3, n) and alive (1, n), or camera (ops/camera.py
Camera: the primary rays it makes itself, as render_kernel.py's wrappers
do).

A lane stops where it dies or where its global bounce reaches
cfg.max_bounces; it then keeps its state, which the mega kernels' lanes do
too, so a staged render equals a mega one lane for lane.  On clustered
scenes (ops/kernels/clusters.py) idx rows, records and B9's cotangent are
in the internal triangle order; the caller maps the cotangent back once
(clusters.unperm_rows).

Each wrapper launches its CUDA kernel (render_fwd.cu: B7, B8;
render_bwd.cu: B9) for CUDA tensors and runs its plain version for CPU
tensors; it never falls back from one to the other on a CUDA tensor.
`<wrapper>.launches` counts kernel launches; each call runs under the span
ipt.launch.<wrapper> (utils/profiling.py).  B7 and B9 run persistent
blocks, as many as fit on the card at once: B7's warps walk fixed ranges
of 32-lane chunks after their block staged the tables (render_fwd.cu
init_kernel), B9's likewise over a stage's records (render_bwd.cu
stage_reverse_kernel); `init_tile.blocks` and `stage_reverse_tile.blocks`
hold the grid of their last launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from inverse_path_tracer_torch.ops.bsdf import INV_PI
from inverse_path_tracer_torch.ops.camera import Camera
from inverse_path_tracer_torch.ops.kernels.clusters import kernel_view, to_kernel_order
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    CARRY_ROWS,
    KernelTables,
    Keys,
    Lanes,
    _check,
    _check_rays,
    _check_rng,
    _count_sweep,
    _library,
    _on_card,
    _ptr,
    _raise_on,
    _ray_inputs,
    _refuse_bvh,
    _trace_params,
    acc_scratch,
    init_lanes,
    run_bounces,
)
from inverse_path_tracer_torch.render.diff import REC_ROWS, BounceRecords, suffix_recursion
from inverse_path_tracer_torch.scene.build import SceneData
from inverse_path_tracer_torch.utils.profiling import spanned


@spanned("ipt.launch.init_tile")
def init_tile(
    materials: torch.Tensor,
    scene: SceneData,
    cfg,
    p: Optional[torch.Tensor] = None,
    d: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    *,
    camera: Optional[Camera] = None,
    tables: Optional[KernelTables] = None,
) -> torch.Tensor:
    """B7: the initial carry (CARRY_ROWS, n) of rays p, d (3, n) with the
    0/1 mask alive (1, n), or of the primary rays of `camera`.  `tables` is
    pack_tables(scene, materials, cfg)."""
    n = _check_rays(p, d, alive, None, camera)
    if not _on_card(p, scene, materials):
        return init_tile_plain(materials, scene, cfg, p, d, alive, camera=camera)
    lib = _library("render_fwd")
    dev = scene.device
    params, tabs = _trace_params(materials, scene, cfg, tables, p, d, alive, camera=camera)
    _refuse_bvh(tabs, "init_tile")
    carry = torch.empty((CARRY_ROWS, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        blocks = ctypes.c_int(0)
        _raise_on(lib, lib.ipt_init_blocks(ctypes.byref(params), ctypes.byref(blocks)),
                  "render_fwd init_tile")
        err = lib.ipt_init_tile(ctypes.byref(params), carry.data_ptr(), blocks.value,
                                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "render_fwd init_tile")
    init_tile.launches += 1
    init_tile.blocks = blocks.value
    _count_sweep(tabs)
    return carry


@spanned("ipt.launch.stage_tile")
def stage_tile(
    materials: torch.Tensor,
    scene: SceneData,
    cfg,
    carry: torch.Tensor,
    orig: torch.Tensor,
    start: int,
    k: int,
    uniforms: Optional[torch.Tensor] = None,
    keys: Optional[Keys] = None,
    with_rec: bool = False,
    *,
    tables: Optional[KernelTables] = None,
    live: Optional[torch.Tensor] = None,
):
    """B8: at most k bounces of every live lane of `carry` from global
    bounce `start`.  `live`, when given, is a (1,) int32 tensor on the
    carry's device: every lane at or past column live[0] is dead (the
    staged orchestration sorts live lanes first and counts them on the
    device), so the kernel only copies those lanes; the result does not
    depend on it.  Returns the carry out, or (carry out, records (k*16,
    n)) when with_rec."""
    n = carry.shape[1]
    _check(carry, {"carry": (carry, (CARRY_ROWS, n), torch.float32),
                   "orig": (orig, (1, n), torch.int32)})
    if live is not None:
        _check(carry, {"live": (live, (1,), torch.int32)})
    _check_rng(carry, uniforms, keys, k * 8)
    if not _on_card(carry, scene, materials):
        return stage_tile_plain(materials, scene, cfg, carry, orig, start, k, uniforms, keys,
                                with_rec)
    lib = _library("render_fwd")
    # The kernel reads the lanes from the carry, not from params.p.
    params, tabs = _trace_params(materials, scene, cfg, tables, carry, uniforms=uniforms,
                                 orig=orig, keys=keys)
    _refuse_bvh(tabs, "stage_tile")
    out = torch.empty_like(carry)
    rec = (torch.empty((k * REC_ROWS, n), dtype=torch.float32, device=carry.device)
           if with_rec else None)
    work = torch.zeros(1, dtype=torch.int32, device=carry.device)  # the kernel's work counter
    with torch.cuda.device(carry.device):
        err = lib.ipt_stage_tile(ctypes.byref(params), carry.data_ptr(), out.data_ptr(),
                                 None if rec is None else rec.data_ptr(), start, k,
                                 None if live is None else live.data_ptr(), work.data_ptr(),
                                 torch.cuda.current_stream(carry.device).cuda_stream)
    _raise_on(lib, err, "render_fwd stage_tile")
    stage_tile.launches += 1
    _count_sweep(tabs)
    return (out, rec) if with_rec else out


@spanned("ipt.launch.stage_reverse_tile")
def stage_reverse_tile(
    n_tri: int, cfg, k: int, rec: torch.Tensor, g: torch.Tensor, suf: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9: the suffix recursion over one stage's records from the (suf,
    esc) carry of the later stages.  Returns (d materials (nT, 3) in the
    records' triangle order, the carry (4, n) toward the earlier bounces)."""
    n = g.shape[1]
    _check(g, {"rec": (rec, (k * REC_ROWS, n), torch.float32), "g": (g, (3, n), torch.float32),
               "suf": (suf, (4, n), torch.float32)})
    if g.device.type == "cpu":
        return stage_reverse_tile_plain(n_tri, cfg, k, rec, g, suf)
    if g.device.type != "cuda":
        raise ValueError(f"stage_reverse_tile runs on CUDA or CPU tensors, got {g.device}")
    suf_out = torch.empty_like(suf)
    if n == 0:
        return torch.zeros((n_tri, 3), dtype=torch.float32, device=g.device), suf_out
    lib = _library("render_bwd")
    with torch.cuda.device(g.device):
        blocks, per_block = ctypes.c_int(0), ctypes.c_longlong(0)
        _raise_on(lib, lib.ipt_stage_reverse_blocks(n, n_tri, k, ctypes.byref(blocks),
                                                    ctypes.byref(per_block)),
                  "render_bwd stage_reverse_tile")
        partials = torch.empty((blocks.value, n_tri, 3), dtype=torch.float32, device=g.device)
        scratch = acc_scratch(blocks.value, per_block.value, g.device)
        err = lib.ipt_stage_reverse_tile(
            rec.data_ptr(), g.data_ptr(), suf.data_ptr(), n, n_tri, k, int(cfg.reference_quirks),
            INV_PI, partials.data_ptr(), suf_out.data_ptr(), _ptr(scratch), blocks.value,
            torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(lib, err, "render_bwd stage_reverse_tile")
    stage_reverse_tile.launches += 1
    stage_reverse_tile.blocks = blocks.value
    return partials.sum(dim=0), suf_out


init_tile.launches = 0
init_tile.blocks = 0
stage_tile.launches = 0
stage_reverse_tile.launches = 0
stage_reverse_tile.blocks = 0


def init_tile_plain(materials, scene, cfg, p=None, d=None, alive=None, *,
                    camera: Optional[Camera] = None) -> torch.Tensor:
    """B7's plain version: render_kernel.init_lanes as a carry (of the
    plain camera_rays' rays in camera mode)."""
    _check_rays(p, d, alive, None, camera)
    p, d, alive, _ = _ray_inputs(scene, cfg, p, d, alive, None, camera)
    return init_lanes(kernel_view(scene, cfg), cfg, p, d, alive).to_carry()


def stage_tile_plain(materials, scene, cfg, carry, orig, start, k, uniforms=None, keys=None,
                     with_rec=False, live=None):
    """B8's plain version: render_kernel.run_bounces on the carry's lanes
    (`live` only bounds where the kernel looks for live lanes)."""
    view = kernel_view(scene, cfg)
    lanes, rec = run_bounces(view, to_kernel_order(materials, view), cfg,
                             Lanes.from_carry(carry), orig, start, k, uniforms, keys, with_rec)
    out = lanes.to_carry()
    return (out, rec) if with_rec else out


def stage_reverse_tile_plain(n_tri, cfg, k, rec, g, suf):
    """B9's plain version: render/diff.py suffix_recursion from the carry."""
    d_mats, s, esc = suffix_recursion(BounceRecords.from_rows(rec), g.T, n_tri,
                                      cfg.reference_quirks, suf[0:3].T, suf[3] > 0)
    return d_mats, torch.cat([s.T, esc.float()[None]]).contiguous()

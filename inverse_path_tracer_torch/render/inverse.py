"""Light-transport-graph extraction (the inverse pass), the counterpart of
the JAX package's render/inverse.py.

The scene is re-traced with the camera of the forward render.  Every path
vertex records an edge dst <- src carrying the running path weight, the
observed colour of the ray's pixel (from the tone-mapped target image) and,
for NEE edges, the emitted radiance.  The eye is node nT.  Edges accumulate
into dense (nT+1) * nT grids (TransportGrids); compress_grids turns them
into the row-normalised log weights and colour features of the GCN.

The reference's conventions (inv_path_trace.cu) are kept:
  * factors[DIFFUSE] = 1/pi on NEE edges, 1 on indirect ones;
  * factors[SPECULAR] = specCoeff / P_SPEC on a specular path, else 0, and
    shininess is forced to 0; specular paths are sampled with p_spec;
  * w *= cos / pdf / p_rr / p_branch;
  * the indirect edge is recorded before the roulette test; a miss records
    nothing;
  * compress: w = log(max(w_sum, 0) + 1), colours divided by factors_sum
    (or 1 where it is 0), then each dst row of w normalised.

Two routes (trace_transport_range):
  * cfg.backend="plain": the wavefront path below, over all lanes of a
    launch at once, with both factor channels and any p_spec.  It is the
    port's oracle, held against the JAX XLA path in the tests.
  * cfg.backend="auto" (needs p_spec == 0): per launch the B5 kernel
    (ops/kernels/inverse_kernel.py inverse_tile), whose grid lives in shared
    memory, on scenes where inverse_grid_fits(); B6 with the global-grid
    sink (inverse_tile_global) otherwise, which adds every launch's edges
    into one float64 grid of the range in the kernels' triangle order,
    mapped back to global order once per range (unperm_grid) on a clustered
    scene (ops/kernels/clusters.py).  No records are written on either
    route.  On CPU tensors the wrappers run their plain versions.

Rays follow render/forward.py: launches of cfg.tile_size global sample
indices.  With cfg.rng="fused" the bounce uniforms are the counter hash of
`key` at the JAX kernel's slots (ops/rng.py), and the camera jitter comes
from the disjoint key rng.fold_in(key, rng.CAMERA_STREAM); the kernels
make the primary rays and read each sample's pixel from the target image
themselves (camera mode), so a launch builds no tensor.  With
cfg.rng="external" the caller passes rays (count, 3) and uniforms
(max_bounces*8, count) in the row layout [spec, pick, r1, r2, rr, phi,
theta, 0] of the JAX _inv_uniforms.  A ray's pixel is
clip(idx // spp, 0, W*H-1), so ranges of samples sum to the whole.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.bsdf import INV_PI, specular_coeff
from inverse_path_tracer_torch.ops.camera import camera_inputs, pixel_index, sample_index
from inverse_path_tracer_torch.ops.intersect import intersect_fast, smooth_normal
from inverse_path_tracer_torch.ops.kernels.inverse_kernel import (
    N_QUANT,
    grids_from_acc,
    inverse_grid_fits,
    inverse_tile,
    inverse_tile_global,
    unperm_grid,
)
from inverse_path_tracer_torch.ops.kernels.clusters import kernel_perm
from inverse_path_tracer_torch.ops.kernels.render_kernel import pack_tables
from inverse_path_tracer_torch.ops.sampling import (
    pick_emissive,
    sample_emissive_point,
    sample_next_dir,
)
from inverse_path_tracer_torch.ops.vec import dot3, normalize3
from inverse_path_tracer_torch.render.forward import RenderStats, _launches, _prepare
from inverse_path_tracer_torch.scene.build import SceneData
from inverse_path_tracer_torch.utils.profiling import span, spanned

# Columns of the wavefront path's grid: w, w*f(2), w*f0*pix(3),
# w*f1*pix(3), w*f0*light(3), w*f1*light(3), n.
N_COLS = 16


class TransportGrids(NamedTuple):
    """Dense edge accumulators over the flattened (dst, src) grid of
    (nT+1) * nT bins (dst == nT is the eye row)."""

    w_sum: torch.Tensor  # (B,)
    pixel_sum: torch.Tensor  # (B, 2, 3)  [channel: DIFFUSE, SPECULAR]
    light_sum: torch.Tensor  # (B, 2, 3)
    factors_sum: torch.Tensor  # (B, 2)
    count: torch.Tensor  # (B,) edge visit count


def _zero_grids(n_tri: int, device) -> torch.Tensor:
    """The wavefront path's accumulator, (B, 16) float64."""
    return torch.zeros(((n_tri + 1) * n_tri, N_COLS), dtype=torch.float64, device=device)


def _grids_from_cols(g: torch.Tensor) -> TransportGrids:
    g = g.to(torch.float32)
    return TransportGrids(
        w_sum=g[:, 0].contiguous(),
        factors_sum=g[:, 1:3].contiguous(),
        pixel_sum=g[:, 3:9].reshape(-1, 2, 3),
        light_sum=g[:, 9:15].reshape(-1, 2, 3),
        count=g[:, 15].contiguous(),
    )


def _edge_update(grid, n_tri, dst, src, w, pixel, light, factors, mask) -> None:
    """Edge::update (inv_scene.h:26-36) for a batch of lanes: index_add_ of
    the 16 quantity columns of the lanes in `mask` into bins dst*nT + src
    (in place).  Masked lanes are dropped, whatever their fields hold."""
    sel = torch.nonzero(mask).squeeze(1)
    w, pixel, light = w[sel], pixel[sel], light[sel]
    wf = w[:, None] * factors[sel]  # (m, 2)
    vals = torch.cat([w[:, None], wf, wf[:, 0:1] * pixel, wf[:, 1:2] * pixel,
                      wf[:, 0:1] * light, wf[:, 1:2] * light,
                      torch.ones_like(w)[:, None]], dim=1)
    grid.index_add_(0, dst[sel] * n_tri + src[sel], vals.to(grid.dtype))


class _InvState(NamedTuple):
    ray_p: torch.Tensor  # (N, 3)
    ray_d: torch.Tensor  # (N, 3)
    weight: torch.Tensor  # (N,)
    factors: torch.Tensor  # (N, 2) previous-bounce BSDF factors
    dst: torch.Tensor  # (N,) int64 previous node (nT = eye)
    alive: torch.Tensor  # (N,) bool


def _inv_bounce(scene: SceneData, cfg: RenderConfig, u: torch.Tensor, pixel: torch.Tensor,
                state: _InvState, grid: torch.Tensor) -> Tuple[_InvState, torch.Tensor]:
    """One inverse bounce of all lanes (JAX inverse.py:168-275; reference
    radiance :109-150 and directLighting :16-87), with u (7, N) in the row
    order spec, pick, r1, r2, rr, phi, theta.  Adds the bounce's edges to
    `grid`; returns the next state and the lanes that hit."""
    n_tri = scene.n_tri
    n = state.ray_p.shape[0]
    isect = intersect_fast(scene, state.ray_p, state.ray_d, cfg.min_dot, cfg.epsilon)
    hit_act = state.alive & isect.hit
    src = isect.tri

    # Indirect edge: (dst, src, previous weight, pixel, no light, previous
    # factors) (:128).
    _edge_update(grid, n_tri, state.dst, src, state.weight, pixel, torch.zeros_like(pixel),
                 state.factors, hit_act)

    # This vertex's path type (:117-118): specular with probability p_spec,
    # shininess forced to 0.
    is_spec = u[0] < cfg.p_spec
    shin = torch.zeros(n, dtype=torch.float32, device=u.device)
    shade_n = smooth_normal(scene, src, isect.point)
    spec_div = max(cfg.p_spec, 1e-30)

    if scene.n_emissive > 0:
        t_emm, p_t = pick_emissive(scene, u[1])
        to_light = normalize3(sample_emissive_point(scene, t_emm, u[2], u[3]) - isect.point)
        cos_theta = dot3(shade_n, to_light)
        shadow = intersect_fast(scene, isect.point, to_light, cfg.min_dot, cfg.epsilon)
        light_n = smooth_normal(scene, t_emm, shadow.point)
        cos_theta_p = -dot3(light_n, to_light)
        ok = (hit_act & (cos_theta >= 0) & shadow.hit & (cos_theta_p >= 0)
              & (shadow.tri == t_emm))
        st = torch.where(ok, shadow.t, torch.ones_like(shadow.t))
        nee_w = state.weight * cos_theta * cos_theta_p / (st * st) / p_t
        # Direct factors (:6-14, :79): DIFFUSE 1/pi, SPECULAR specCoeff/P_SPEC.
        spec_c = specular_coeff(shin, shade_n, state.ray_d, to_light)
        f_spec = torch.where(is_spec, spec_c / spec_div, torch.zeros_like(spec_c))
        nee_factors = torch.stack([torch.full_like(f_spec, INV_PI), f_spec], dim=-1)
        _edge_update(grid, n_tri, src, t_emm, nee_w, pixel, scene.emission[t_emm],
                     nee_factors, ok)

    # Russian roulette and the next bounce (:134-147).
    cont = hit_act & (u[4] < cfg.p_rr)
    next_dir, pdf = sample_next_dir(scene.face_normal[src], is_spec, shin, u[5], u[6])
    spec_c2 = specular_coeff(shin, shade_n, state.ray_d, next_dir)
    f_spec2 = torch.where(is_spec, spec_c2 / spec_div, torch.zeros_like(spec_c2))
    next_factors = torch.stack([torch.ones_like(f_spec2), f_spec2], dim=-1)
    cosine = dot3(next_dir, shade_n)
    p_branch = torch.where(is_spec, torch.full_like(pdf, cfg.p_spec),
                           torch.full_like(pdf, 1.0 - cfg.p_spec))
    w_next = state.weight * cosine / torch.where(pdf > 0, pdf, torch.ones_like(pdf)) \
        / cfg.p_rr / p_branch
    w_next = torch.where(pdf > 0, w_next, torch.zeros_like(w_next))

    c1 = cont[:, None]
    return _InvState(
        ray_p=torch.where(c1, isect.point, state.ray_p),
        ray_d=torch.where(c1, next_dir, state.ray_d),
        weight=torch.where(cont, w_next, state.weight),
        factors=torch.where(c1, next_factors, state.factors),
        dst=torch.where(cont, src, state.dst),
        alive=cont,
    ), hit_act


def _wavefront_launch(scene, cfg, a, target_flat, grid) -> torch.Tensor:
    """The wavefront path over one launch's lanes (the rays of a camera
    launch made by camera_rays); adds to `grid` and returns the launch's
    (segments, shadow rays)."""
    if "camera" in a:
        idx = sample_index(a["camera"], target_flat.device)
        a = dict(a, **camera_inputs(scene, cfg, a["camera"]), uniforms=None)
    else:
        idx = a["orig"][0]
    pixel = target_flat[pixel_index(cfg, idx)]
    n = a["p"].shape[1]
    keys = a["keys"]
    h_orig = rng.hash_orig(keys, a["orig"][0]) if keys is not None else None
    ones = torch.ones(n, dtype=torch.float32, device=pixel.device)
    state = _InvState(ray_p=a["p"].T, ray_d=a["d"].T, weight=ones,
                      factors=torch.stack([ones, ones], dim=-1),
                      dst=torch.full((n,), scene.n_tri, dtype=torch.int64, device=pixel.device),
                      alive=a["alive"][0] > 0)
    counts = torch.zeros(2, dtype=torch.float64, device=pixel.device)
    for b in range(cfg.max_bounces):
        if not bool(state.alive.any()):
            break
        u = rng.draw(keys, h_orig, b, range(7)) if keys is not None else a["uniforms"][8 * b : 8 * b + 7]
        counts[0] += state.alive.sum()
        state, hit_act = _inv_bounce(scene, cfg, u, pixel, state, grid)
        if scene.n_emissive > 0:
            counts[1] += hit_act.sum()
    return counts


@spanned("ipt.extract.range")
def trace_transport_range(
    scene: SceneData,
    target_image01: torch.Tensor,
    key: int,
    cfg: RenderConfig,
    start: int,
    count: int,
    *,
    rays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[TransportGrids, RenderStats]:
    """Transport grids of the `count` samples from global index `start`
    (grids of disjoint ranges sum to the grids of their union).

    target_image01 is the (H, W, 3) observed image in [0, 1].  Routes and RNG
    are described in the module docstring; cfg.backend="auto" needs p_spec
    == 0 and raises otherwise.  B5 takes scenes where inverse_grid_fits()
    (grid and tables within 227 KB of shared memory, about nT <= 78 on a
    flat scene); B6's global-grid sink takes larger ones.

    Returns TransportGrids (float32) and the RenderStats (segments, shadow
    rays) of the trace, counted per lane as the forward kernel counts them.
    The extraction always sweeps: cfg.intersect is not read, as in the JAX
    package."""
    cfg = cfg.with_(intersect="auto")
    dev, scene, _, ext = _prepare(scene.diffuse, scene, cfg, count, rays, uniforms, device)
    target_flat = target_image01.to(device=dev, dtype=torch.float32).reshape(-1, 3).contiguous()
    if target_flat.shape[0] != cfg.width * cfg.height:
        raise ValueError(f"target image {tuple(target_image01.shape)} does not match "
                         f"{cfg.height}x{cfg.width}")
    nt = scene.n_tri
    if cfg.backend == "plain":
        route = "wavefront"
    else:
        tables = pack_tables(scene, scene.diffuse, cfg) if dev.type == "cuda" else None
        perm = kernel_perm(scene, cfg)
        route = "grid" if inverse_grid_fits(scene) else "global"
    with span("ipt.prep.grid"):
        grid = (_zero_grids(nt, dev) if route == "wavefront" else
                torch.zeros((nt + 1, nt, N_QUANT), dtype=torch.float64, device=dev))
    totals = torch.zeros(2, dtype=torch.float64, device=dev)
    camera_key = rng.fold_in(key, rng.CAMERA_STREAM)
    for _lo, _hi, a in _launches(scene, cfg, key, start, count, ext, camera_key=camera_key):
        if route == "wavefront":
            totals += _wavefront_launch(scene, cfg, a, target_flat, grid)
            continue
        if "camera" in a:  # the kernels read each sample's pixel from the image
            pixels = dict(image=target_flat)
        else:
            pixels = dict(pix=target_flat[pixel_index(cfg, a["orig"][0])].T.contiguous())
        if route == "grid":
            out, stats = inverse_tile(scene, cfg, tables=tables, **pixels, **a)
            grid += out
        else:
            _, stats = inverse_tile_global(scene, cfg, tables=tables, acc=grid, **pixels, **a)
        totals += stats.sum(dim=1, dtype=torch.float64)
    with span("ipt.extract.finish"):
        if route == "global":  # the kernels' order -> global, once per range
            grid = unperm_grid(grid, perm)
        grids = _grids_from_cols(grid) if route == "wavefront" else grids_from_acc(grid)
    counts = totals.to(torch.int64)
    return grids, RenderStats(segments=counts[0], shadow_rays=counts[1])


@spanned("ipt.extract.compress")
def compress_grids(grids: TransportGrids, n_tri: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DataWrapper::compress (inv_scene.h:87-115): returns
    (w (nT+1, nT) row-normalised log weights,
     pixel (nT+1, nT, 3) DIFFUSE channel,
     light (nT+1, nT, 3) DIFFUSE channel).

    The log's argument is clamped at zero: on vertex-normal scenes a path
    weight can be negative (cosine against the smooth normal), and log of a
    bin below -1 would be NaN; on flat scenes the clamp changes nothing."""
    w = torch.log(torch.clamp(grids.w_sum, min=0.0) + 1.0).reshape(n_tri + 1, n_tri)
    f = grids.factors_sum
    denom = torch.where(f != 0.0, f, torch.ones_like(f))[:, :, None]
    pixel = (grids.pixel_sum / denom)[:, 0, :].reshape(n_tri + 1, n_tri, 3)
    light = (grids.light_sum / denom)[:, 0, :].reshape(n_tri + 1, n_tri, 3)
    row = w.sum(dim=1, keepdim=True)
    w = torch.where(row != 0.0, w / torch.where(row != 0.0, row, torch.ones_like(row)),
                    torch.zeros_like(w))
    return w, pixel, light


def extract_graph(
    scene: SceneData,
    target_image01: torch.Tensor,
    key: int,
    cfg: RenderConfig,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-image transport extraction (reference generate_data
    ipt_cuda.py:136-165): (w, pixel, light) of compress_grids over all
    W*H*spp samples.  `kw` goes to trace_transport_range (device, rays and
    uniforms)."""
    grids, _ = trace_transport_range(scene, target_image01, key, cfg, 0, cfg.n_samples, **kw)
    return compress_grids(grids, scene.n_tri)

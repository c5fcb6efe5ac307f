"""Forward Monte-Carlo path tracer with next-event estimation.

The per-bounce math is the JAX package's (render/forward.py), including the
reference quirks, active when cfg.reference_quirks (the default):

  (Q1) first-hit emission L_e is never cleared and is re-added at every
       bounce, scaled by the running throughput;
  (Q2) an escaping ray still adds prev_mult * (L_e + L_d) with the stale
       L_d of the previous bounce;
  (Q3) cosine-sampled diffuse directions carry pdf 1/pi;
  (Q4) the NEE weight divides by the light's selection probability only.

With reference_quirks=False, (Q1) adds emission once and (Q2) adds nothing.

Entry points take device=None, meaning "cuda", and raise when CUDA is not
available; the CPU runs only when asked for (device="cpu").  Rays run in
launches of cfg.tile_size samples through ops/kernels/render_kernel
(the CUDA kernels on the card, their plain versions on the CPU or with
cfg.backend="plain"), in one of two organisations (_use_staged).  With the
fused RNG a launch passes no ray tensors: the kernels make the primary
rays of its samples themselves (camera mode, ops/camera.py Camera), and
the plain versions make the same rays with camera_rays.

  * mega: render_range through B1 forward and B2 backward under autograd,
    loss_and_grad_range through B3 and B4; the BVH route
    (cfg.intersect="bvh" on a scene with a BVH) is always mega, its
    kernels searching by BVH traversal;
  * staged (ops/kernels/staged_kernel.py): per launch B7 intersects the
    primary rays into a lane carry, then B8 runs stages of
    cfg.stage_bounces bounces; before each stage the carry is stably
    re-sorted, live lanes first (and, on clustered scenes, binned by ray
    direction and origin), so that trailing blocks hold dead lanes only.
    The gradient reruns the stages with records and chains B9 backwards
    through the stage orders.  Lane arithmetic does not depend on the lane
    order, so a staged render equals a mega one sample for sample.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.camera import (  # noqa: F401 (camera_rays* re-exported)
    Camera,
    camera_rays,
    camera_rays_from_jitter,
)
from inverse_path_tracer_torch.ops.kernels.clusters import (
    cluster_k_for,
    kernel_perm,
    unperm_rows,
    uses_bvh,
)
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    CAR_ALIVE,
    CAR_RAD,
    CAR_STATS,
    grad_tile,
    grad_tile_plain,
    pack_tables,
    render_tile,
    render_tile_plain,
    render_tile_rec,
    render_tile_rec_plain,
    reverse_tile,
    reverse_tile_plain,
)
from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
    init_tile,
    init_tile_plain,
    stage_reverse_tile,
    stage_reverse_tile_plain,
    stage_tile,
    stage_tile_plain,
)
from inverse_path_tracer_torch.ops.tonemap import tonemap_mean, tonemap_to_uint8
from inverse_path_tracer_torch.scene.build import SceneData
from inverse_path_tracer_torch.utils.png import write_png
from inverse_path_tracer_torch.utils.profiling import span, spanned


class RenderStats(NamedTuple):
    """Ray accounting for rays/s (int64 scalars: a float32 running sum
    loses counts at 512x512x64 spp x 16 bounces)."""

    segments: torch.Tensor  # path segments traced (alive lanes per bounce)
    shadow_rays: torch.Tensor  # NEE shadow rays traced (hit lanes per bounce)


def resolve_device(device=None) -> torch.device:
    """device=None means CUDA; raise rather than run somewhere else."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class _Kernels(NamedTuple):
    """The per-launch functions of one range: the forward (B1), the forward
    with records (B3), the fused backward (B2), the reverse on records (B4)
    and the staged kernels (B7, B8, B9), or their plain versions; `perm`
    maps the kernels' internal triangle rows back to global ones."""

    fwd: Callable
    fwd_rec: Callable
    grad: Callable
    reverse: Callable
    init: Callable
    stage: Callable
    stage_reverse: Callable
    perm: Optional[torch.Tensor]


def _kernels(cfg: RenderConfig, scene: SceneData, materials: torch.Tensor) -> _Kernels:
    """cfg.backend="plain" takes the plain versions on any device; otherwise
    the wrappers (the kernels on the card, the plain versions on the CPU),
    with the kernel's tables packed once per range, not once per launch."""
    perm = kernel_perm(scene, cfg)
    if cfg.backend == "plain":
        return _Kernels(render_tile_plain, render_tile_rec_plain, grad_tile_plain,
                        reverse_tile_plain, init_tile_plain, stage_tile_plain,
                        stage_reverse_tile_plain, perm)
    tables = pack_tables(scene, materials, cfg) if scene.device.type == "cuda" else None
    with_tables = lambda fn: functools.partial(fn, tables=tables)
    return _Kernels(with_tables(render_tile), with_tables(render_tile_rec),
                    with_tables(grad_tile), reverse_tile, with_tables(init_tile),
                    with_tables(stage_tile), stage_reverse_tile, perm)


def _use_staged(cfg: RenderConfig, scene: SceneData) -> bool:
    """The bounce-loop organisation (JAX render/forward.py:580-611): "auto"
    is staged exactly where the scene is clustered (cluster_k_for > 0: at
    least CLUSTER_MIN_TP padded triangles), "mega" and "staged" force either (an
    unknown value is refused by RenderConfig).  The BVH route
    (clusters.uses_bvh) is mega whatever cfg.wavefront says, as the JAX
    package's is one unstaged wavefront."""
    if uses_bvh(scene, cfg):
        return False
    if cfg.wavefront == "auto":
        return cluster_k_for(scene.n_tri, cfg) > 0
    return cfg.wavefront == "staged"


def _stage_plan(cfg: RenderConfig) -> Tuple[int, int]:
    """(bounces per stage, number of stages)."""
    k = max(1, min(cfg.stage_bounces, cfg.max_bounces))
    return k, -(-cfg.max_bounces // k)


def _alive_first_order(alive: torch.Tensor) -> torch.Tensor:
    """Stable partition of the lanes, alive (> 0) first: new[j] =
    old[order[j]] (JAX render/forward.py:620)."""
    return torch.sort((alive <= 0).to(torch.int32), stable=True).indices


def _binned_order(carry: torch.Tensor, lo: torch.Tensor, inv_ext: torch.Tensor,
                  cells: int) -> torch.Tensor:
    """Alive-first and ray-binned stable order of the carry's lanes (JAX
    render/forward.py:635): key ((dead * 8 + direction octant) * cells^3 +
    origin cell), the cell of the next origin in a cells^3 grid over the
    scene's box.  Alive lanes still come strictly first; within them, rays
    of one direction octant and region share warps, so that their cluster
    box tests agree."""
    d, p = carry[0:3], carry[3:6]
    dead = (carry[CAR_ALIVE] <= 0).to(torch.int64)
    octant = (d[0] > 0).long() + 2 * (d[1] > 0).long() + 4 * (d[2] > 0).long()
    cidx = torch.clamp(((p - lo[:, None]) * inv_ext[:, None] * cells).to(torch.int32), 0,
                       cells - 1).long()
    cell = cidx[0] + cells * (cidx[1] + cells * cidx[2])
    key = (dead * 8 + octant) * cells**3 + cell
    return torch.sort(key, stable=True).indices


@spanned("ipt.prep.bins")
def _scene_bins(scene: SceneData, cfg: RenderConfig):
    """(lo, inv_ext) of the scene's box for _binned_order on clustered
    scenes, None elsewhere (alive-first order)."""
    if cluster_k_for(scene.n_tri, cfg) == 0:
        return None
    v = scene.vertices.reshape(-1, 3)
    lo = v.min(dim=0).values
    ext = v.max(dim=0).values - lo
    return lo, 1.0 / torch.where(ext > 0, ext, torch.ones_like(ext))


class _StageRecords(NamedTuple):
    rec: torch.Tensor  # (k*16, n) the stage's records
    order: torch.Tensor  # (n,) lane j of the stage was lane order[j] before it
    local: torch.Tensor  # (n,) launch-local sample index of each lane


def _staged_launch(kern, materials, scene, cfg, a, base: int, bins, with_rec: bool):
    """The staged forward of one launch (JAX render/forward.py:682): B7,
    then per stage the stable re-sort and B8, external uniforms (padded to
    whole stages) gathered by each lane's sample.  `base` is the launch's
    first global sample index.  In camera mode B7 makes the primary rays,
    and one arange gives the lanes' global indices, which B8's hash and the
    re-sorts carry.  Returns (radiance (3, n) in sample order, per-lane
    counts (2, n) in the last stage's order, the stages' records when
    with_rec)."""
    k, n_stages = _stage_plan(cfg)
    if "camera" in a:
        n = a["camera"].n
        carry = kern.init(materials, scene, cfg, camera=a["camera"])
        orig = torch.arange(base, base + n, dtype=torch.int64,
                            device=scene.device).to(torch.int32)[None, :]
    else:
        n = a["p"].shape[1]
        carry = kern.init(materials, scene, cfg, a["p"], a["d"], a["alive"])
        orig = a["orig"]
    u = a.get("uniforms")
    if u is not None and n_stages * k > cfg.max_bounces:
        u = torch.cat([u, u.new_zeros(((n_stages * k - cfg.max_bounces) * 8, n))])
    stages = []
    for s in range(n_stages):
        with span("ipt.staged.reorder"):
            order = (_binned_order(carry, *bins, cfg.bin_cells) if bins is not None
                     else _alive_first_order(carry[CAR_ALIVE]))
            carry = carry[:, order].contiguous()
            orig = orig[:, order].contiguous()
            local = orig[0].long() - base
            u_s = None if u is None else u[s * k * 8 : (s + 1) * k * 8][:, local].contiguous()
            # The live lanes come first; B8 takes their count on the device.
            live = (carry[CAR_ALIVE] > 0).sum(dtype=torch.int32).reshape(1)
        out = kern.stage(materials, scene, cfg, carry, orig, s * k, k, uniforms=u_s,
                         keys=a["keys"], with_rec=with_rec, live=live)
        if with_rec:
            carry, rec = out
            stages.append(_StageRecords(rec, order, local))
        else:
            carry = out
    rad = torch.empty((3, n), dtype=torch.float32, device=carry.device)
    rad[:, orig[0].long() - base] = carry[CAR_RAD]
    return rad, carry[CAR_STATS], stages


def _staged_reverse(kern, n_tri: int, cfg, g: torch.Tensor, stages) -> torch.Tensor:
    """The staged recursion of one launch (JAX render/forward.py:815): B9
    per stage, last stage first, the (suf, esc) carry moved back to the
    previous stage's lane order between launches.  g (3, n) is in sample
    order; returns d materials (nT, 3) in the kernels' triangle order."""
    k, _ = _stage_plan(cfg)
    suf = torch.zeros((4, g.shape[1]), dtype=torch.float32, device=g.device)
    d_mats = torch.zeros((n_tri, 3), dtype=torch.float32, device=g.device)
    for st in reversed(stages):
        with span("ipt.staged.reorder"):
            g_st = g[:, st.local].contiguous()
        dm, suf_out = kern.stage_reverse(n_tri, cfg, k, st.rec, g_st, suf)
        with span("ipt.staged.reorder"):
            suf = torch.empty_like(suf_out)
            suf[:, st.order] = suf_out
        d_mats = d_mats + dm
    return d_mats


class _External(NamedTuple):
    """Caller-supplied rays and uniforms of a whole range (rng="external")."""

    p: torch.Tensor  # (count, 3)
    d: torch.Tensor  # (count, 3)
    uniforms: torch.Tensor  # (max_bounces*8, count)


def _prepare(materials, scene, cfg, count, rays, uniforms, device):
    """The device, the scene and materials on it (materials stay attached
    to autograd) and, with rng="external", the checked rays and uniforms."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    materials = materials.to(device=dev, dtype=torch.float32)
    if cfg.rng != "external":
        if rays is not None or uniforms is not None:
            raise ValueError("rays/uniforms are only read with rng='external'")
        return dev, scene, materials, None
    if rays is None or uniforms is None:
        raise ValueError("rng='external' needs rays=(p, d) and uniforms")
    p_all, d_all = (r.to(device=dev, dtype=torch.float32) for r in rays)
    u_all = uniforms.to(device=dev, dtype=torch.float32)
    if p_all.shape != (count, 3) or d_all.shape != (count, 3):
        raise ValueError(f"rays must be (count, 3) = ({count}, 3)")
    if u_all.shape != (cfg.max_bounces * 8, count):
        raise ValueError(f"uniforms must be ({cfg.max_bounces * 8}, {count})")
    return dev, scene, materials, _External(p_all, d_all, u_all)


def _launches(scene, cfg, key, start, count, ext: Optional[_External],
              camera_key: Optional[int] = None):
    """(lo, hi, kernel inputs) of each launch of cfg.tile_size samples.  The
    backward rebuilds exactly the forward's rays from the same key and
    global indices (or slices the same external rays and uniforms).  With
    the fused RNG a launch's inputs are camera=Camera(start + lo, hi - lo,
    camera_key (default: `key`)), whose rays the kernels make, and the
    bounce uniforms' keys of `key`: no tensor is built."""
    dev = scene.device
    keys = None if ext is not None else rng.key_words(key)
    camera_key = key if camera_key is None else camera_key
    tile = max(1, min(cfg.tile_size, count))
    for lo in range(0, count, tile):
        hi = min(lo + tile, count)
        if ext is None:
            yield lo, hi, dict(camera=Camera(start + lo, hi - lo, camera_key), keys=keys)
            continue
        idx = torch.arange(start + lo, start + hi, dtype=torch.int64, device=dev)
        alive = (idx < cfg.n_samples).to(torch.float32)[None, :]
        yield lo, hi, dict(p=ext.p[lo:hi].T.contiguous(), d=ext.d[lo:hi].T.contiguous(),
                           alive=alive, uniforms=ext.uniforms[:, lo:hi].contiguous(),
                           orig=idx.to(torch.int32)[None, :].contiguous(), keys=None)


@spanned("ipt.render.grad")
def _grad_launches(materials, scene, key, cfg, start, count, g_vals, ext) -> torch.Tensor:
    kern = _kernels(cfg, scene, materials)
    n_tri = scene.n_tri
    d_mats = torch.zeros((n_tri, 3), dtype=torch.float32, device=scene.device)
    if not _use_staged(cfg, scene):
        for lo, hi, a in _launches(scene, cfg, key, start, count, ext):
            d_mats = d_mats + kern.grad(materials, scene, cfg, g=g_vals[lo:hi].T.contiguous(), **a)
        return d_mats
    # The staged gradient (JAX render/forward.py:857): per launch the
    # stages again with records, then the chained recursion; the kernels'
    # rows are mapped back once for the range.
    bins = _scene_bins(scene, cfg)
    for lo, hi, a in _launches(scene, cfg, key, start, count, ext):
        _, _, stages = _staged_launch(kern, materials, scene, cfg, a, start + lo, bins, True)
        d_mats = d_mats + _staged_reverse(kern, n_tri, cfg, g_vals[lo:hi].T.contiguous(), stages)
    return unperm_rows(d_mats, kern.perm)


class _RenderRange(torch.autograd.Function):
    """render_range with the material gradient of the kernels (the
    counterpart of _render_range_pallas and its defvjp, JAX
    render/forward.py:1091-1127): mega, the forward runs B1 per launch and
    the backward B2 per launch on the forward's rays; staged, B7 and B8,
    then B7, B8 with records and B9."""

    @staticmethod
    @spanned("ipt.render.range")
    def forward(ctx, materials, scene, key, cfg, start, count, ext):
        kern = _kernels(cfg, scene, materials)
        staged = _use_staged(cfg, scene)
        bins = _scene_bins(scene, cfg) if staged else None
        out = torch.empty((count, 3), dtype=torch.float32, device=scene.device)
        totals = torch.zeros(2, dtype=torch.float64, device=scene.device)
        for lo, hi, a in _launches(scene, cfg, key, start, count, ext):
            if staged:
                rad, stats, _ = _staged_launch(kern, materials, scene, cfg, a, start + lo, bins,
                                               False)
            else:
                rad, stats = kern.fwd(materials, scene, cfg, **a)
            out[lo:hi] = rad.T
            totals += stats.sum(dim=1, dtype=torch.float64)
        counts = totals.to(torch.int64)
        ctx.mark_non_differentiable(counts)
        ctx.save_for_backward(materials)
        ctx.range = (scene, key, cfg, start, count, ext)
        return out, counts

    @staticmethod
    def backward(ctx, g_vals, _g_counts):
        (materials,) = ctx.saved_tensors
        scene, key, cfg, start, count, ext = ctx.range
        d_mats = _grad_launches(materials, scene, key, cfg, start, count,
                                g_vals.to(torch.float32), ext)
        return d_mats, None, None, None, None, None, None


def render_range(
    materials: torch.Tensor,
    scene: SceneData,
    key: int,
    cfg: RenderConfig,
    start: int,
    count: int,
    *,
    rays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, RenderStats]:
    """Radiance (count, 3) for the global sample indices start..start+count,
    differentiable in `materials` (the backward is grad_range).

    cfg.rng="fused": rays and uniforms come from the counter hash of `key`
    and the global sample index, so the result does not depend on
    cfg.tile_size or on how a render is split into ranges.
    cfg.rng="external": `rays` = (p, d), each (count, 3), and `uniforms`
    (max_bounces*8, count) are supplied by the caller; `key` is unused."""
    _, scene, materials, ext = _prepare(materials, scene, cfg, count, rays, uniforms, device)
    out, counts = _RenderRange.apply(materials, scene, key, cfg, start, count, ext)
    return out, RenderStats(segments=counts[0], shadow_rays=counts[1])


def grad_range(
    materials: torch.Tensor,
    scene: SceneData,
    key: int,
    cfg: RenderConfig,
    start: int,
    count: int,
    g_vals: torch.Tensor,
    *,
    rays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """d(sum g_vals * radiance)/d materials (nT, 3) for the range of
    render_range, through B2 per launch, or B7, B8 and B9 when staged (the
    counterpart of _grad_range_pallas, JAX render/forward.py:902-958).
    g_vals is (count, 3)."""
    dev, scene, materials, ext = _prepare(materials, scene, cfg, count, rays, uniforms, device)
    if tuple(g_vals.shape) != (count, 3):
        raise ValueError(f"g_vals must be ({count}, 3), got {tuple(g_vals.shape)}")
    g_vals = g_vals.to(device=dev, dtype=torch.float32)
    return _grad_launches(materials.detach(), scene, key, cfg, start, count, g_vals, ext)


@spanned("ipt.render.range")
def loss_and_grad_range(
    materials: torch.Tensor,
    scene: SceneData,
    key: int,
    cfg: RenderConfig,
    start: int,
    count: int,
    tile_post: Callable[[torch.Tensor, int], torch.Tensor],
    *,
    rays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, RenderStats]:
    """A scalar loss and its material gradient over a sample range, the
    training path of the JAX package's loss_and_grad_range
    (render/forward.py:961-1079).

    tile_post(vals (n, 3), launch_start) -> the scalar loss of one launch of
    n <= cfg.tile_size consecutive samples starting at global index
    launch_start; the launches' losses are summed.  Lanes past the last
    sample render as zeros.  Per launch, mega: B3 renders and writes its
    records, autograd differentiates tile_post, and B4 turns the records
    and that cotangent into the (nT, 3) gradient, with no replay of the
    bounce loop; staged: B7 and B8 with records, then B9 per stage.  Like
    JAX this needs whole pixels per launch: cfg.tile_size (when it is below
    count) a multiple of cfg.spp.  The gradient equals that of render_range
    under autograd.

    Returns (loss, d_materials (nT, 3), stats)."""
    tile = max(1, min(cfg.tile_size, count))
    if tile < count and tile % cfg.spp:
        raise ValueError(f"tile_size {cfg.tile_size} must be a multiple of spp {cfg.spp}")
    _, scene, materials, ext = _prepare(materials, scene, cfg, count, rays, uniforms, device)
    materials = materials.detach()
    kern = _kernels(cfg, scene, materials)
    staged = _use_staged(cfg, scene)
    bins = _scene_bins(scene, cfg) if staged else None
    dev = scene.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    d_mats = torch.zeros((scene.n_tri, 3), dtype=torch.float32, device=dev)
    totals = torch.zeros(2, dtype=torch.float64, device=dev)
    for lo, _hi, a in _launches(scene, cfg, key, start, count, ext):
        if staged:
            rad, stats, stages = _staged_launch(kern, materials, scene, cfg, a, start + lo, bins,
                                                True)
        else:
            rad, stats, rec = kern.fwd_rec(materials, scene, cfg, **a)
        vals = rad.T.detach().requires_grad_()
        with torch.enable_grad():
            lt = tile_post(vals, start + lo)
        (g,) = torch.autograd.grad(lt, vals, allow_unused=True, materialize_grads=True)
        if staged:
            d_mats = d_mats + _staged_reverse(kern, scene.n_tri, cfg, g.T.contiguous(), stages)
        else:
            d_mats = d_mats + kern.reverse(scene.n_tri, cfg, rec, g.T.contiguous())
        loss = loss + lt.detach()
        totals += stats.sum(dim=1, dtype=torch.float64)
    counts = totals.to(torch.int64)
    return loss, unperm_rows(d_mats, kern.perm), RenderStats(segments=counts[0],
                                                             shadow_rays=counts[1])


def render_samples(
    materials: torch.Tensor, scene: SceneData, key: int, cfg: RenderConfig, **kw
) -> Tuple[torch.Tensor, RenderStats]:
    """Per-sample radiance (W*H*spp, 3) for all samples, and RenderStats."""
    return render_range(materials, scene, key, cfg, 0, cfg.n_samples, **kw)


def render_image(
    materials: torch.Tensor, scene: SceneData, key: int, cfg: RenderConfig, **kw
) -> torch.Tensor:
    """Tone-mapped (H, W, 3) float image in [0, 1)."""
    samples, _ = render_samples(materials, scene, key, cfg, **kw)
    return tonemap_mean(samples, cfg.spp).reshape(cfg.height, cfg.width, 3)


def render_to_png(
    materials: torch.Tensor, scene: SceneData, key: int, cfg: RenderConfig,
    path: str, **kw
) -> torch.Tensor:
    """Render, write an 8-bit RGB PNG, and return the (H, W, 3) uint8 image
    (on the CPU)."""
    img8 = tonemap_to_uint8(render_image(materials, scene, key, cfg, **kw)).cpu()
    write_png(path, img8.numpy())
    return img8

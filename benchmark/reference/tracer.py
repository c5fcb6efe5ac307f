"""The plain reference of the three timed paths, in PyTorch: the forward
path tracer with next-event estimation, its loss and Adam for recovery, and
the transport-graph extraction.  It imports nothing of the program under
test and takes none of its tables: only the scene built by scene.py from
the raw asset files, the seeds' keys and the benchmark's inputs.

The estimator is the upstream renderer's (path_trace.cu,
inv_path_trace.cu) with its quirks, as the port states them:

  (Q1) first-hit emission is re-added at every bounce, scaled by the
       running throughput;
  (Q2) a ray that escapes still adds throughput * (emission + the previous
       bounce's direct light);
  (Q3) cosine-sampled diffuse directions carry pdf 1/pi;
  (Q4) the light sample divides by the light's selection probability only.

Russian roulette continues with probability p_rr, at most `bounces`
bounces.  Closest hits test every triangle of every object whose box the
ray meets (plane test |n.d| >= 1e-4, t >= 1e-2, three edge planes, lowest
index on ties).  Lanes
are compacted every bounce, so only live rays are traced.

`dt` is the precision of every floating-point value: float32 as the
configurations state, or bfloat16 for the control (control.py).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference import rng

MIN_DOT, EPS = 1e-4, 1e-2
INV_PI = 1.0 / math.pi
CHUNK = 1 << 26  # (rays x triangles) elements per piece of a sweep


def on(scene: Dict[str, torch.Tensor], device, dt) -> Dict[str, torch.Tensor]:
    """The scene on `device`, floating arrays in `dt`."""
    out = {}
    for k, v in scene.items():
        if v is None:
            out[k] = None
        else:
            out[k] = v.to(device=device, dtype=dt if v.is_floating_point() else v.dtype)
    return out


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def unit(v, exact_root: bool = False):
    """v / |v|, zero rows unchanged; exact_root takes the root in float64
    (the correctly rounded root of a float32)."""
    sq = dot(v, v)
    n = torch.sqrt(sq.double()).to(v.dtype) if exact_root else torch.sqrt(sq)
    return v / torch.where(n > 0, n, torch.ones_like(n))[..., None]


def camera(sc, width: int, height: int, spp: int, idx, u1, u2):
    """Primary directions of global samples idx = (row * W + col) * spp + s,
    jittered by (u1, u2) inside the pixel; origins are 0."""
    dt, dev = u1.dtype, u1.device
    r = (idx // (spp * width)).to(dt)
    c = ((idx // spp) % width).to(dt)
    x = 2.0 * (c + u1) / torch.tensor(float(width), dtype=dt, device=dev) - 1.0
    y = 1.0 - 2.0 * (r + u2) / torch.tensor(float(height), dtype=dt, device=dev)
    d = unit(torch.stack([x, y, torch.ones_like(x)], dim=-1), exact_root=True)
    m = sc["m33"]
    return unit(d[:, 0:1] * m[:, 0] + d[:, 1:2] * m[:, 1] + d[:, 2:3] * m[:, 2], exact_root=True)


def _dense(pl, p, d):
    """(t, local triangle) of the closest hit over planes pl, +inf where
    none: every ray against every triangle, in pieces."""
    n_tri, n_rays = pl.shape[0], p.shape[0]
    t_best = torch.empty(n_rays, dtype=p.dtype, device=p.device)
    tri = torch.empty(n_rays, dtype=torch.int64, device=p.device)

    def proj(j, v, with_w):
        out = (v[:, 0:1] * pl[None, :, 4 * j] + v[:, 1:2] * pl[None, :, 4 * j + 1]
               + v[:, 2:3] * pl[None, :, 4 * j + 2])
        return out + pl[None, :, 4 * j + 3] if with_w else out

    step = max(1, CHUNK // n_tri)
    for lo in range(0, n_rays, step):
        ps, ds = p[lo:lo + step], d[lo:lo + step]
        b0 = proj(0, ds, False)
        t = proj(0, ps, True) / (-b0)
        ok = (torch.abs(b0) >= MIN_DOT) & (t >= EPS)
        for j in (1, 2, 3):
            ok &= proj(j, ps, True) + t * proj(j, ds, False) <= 0.0
        t_best[lo:lo + step], tri[lo:lo + step] = torch.min(
            torch.where(ok, t, torch.full_like(t, float("inf"))), dim=1)
    return t_best, tri


def _enters(box, p, d):
    """Rays whose half-line meets the box [lo xyz, hi xyz]."""
    tiny = torch.where(d < 0, torch.full_like(d, -1e-20), torch.full_like(d, 1e-20))
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)
    t1, t2 = (box[0:3] - p) * inv, (box[3:6] - p) * inv
    t_min = torch.minimum(t1, t2).max(dim=1).values
    t_max = torch.maximum(t1, t2).min(dim=1).values
    return t_max >= torch.clamp(t_min, min=0.0)


def closest_hit(sc, p, d) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(t, triangle, point, hit) of rays (R, 3): for each object in turn,
    the rays that meet its padded box against every one of its triangles;
    a later object's hit replaces the running one only when strictly
    closer, so ties keep the lowest triangle index, as a sweep over all
    triangles does."""
    n = p.shape[0]
    t_best = torch.full((n,), float("inf"), dtype=p.dtype, device=p.device)
    tri = torch.zeros(n, dtype=torch.int64, device=p.device)
    for (lo, hi), box in zip(sc["groups"].tolist(), sc["boxes"]):
        rows = torch.nonzero(_enters(box, p, d)).squeeze(1)
        if rows.numel() == 0:
            continue
        t_g, i_g = _dense(sc["planes"][lo:hi], p[rows], d[rows])
        better = t_g < t_best[rows]
        t_best[rows] = torch.where(better, t_g, t_best[rows])
        tri[rows] = torch.where(better, i_g + lo, tri[rows])
    hit = torch.isfinite(t_best)
    point = p + d * torch.where(hit, t_best, torch.zeros_like(t_best))[:, None]
    return t_best, tri, point, hit


def shading_normal(sc, tri, point):
    """The face normal on flat scenes; on vertex-normal ones the corner
    normals weighted by the barycentric areas at `point`, normalized."""
    if sc["vn"] is None:
        return sc["fn"][tri]
    v, ns, area = sc["v"][tri], sc["vn"][tri], sc["area"][tri]
    a = torch.where(area > 0, area, torch.ones_like(area))
    acc = torch.zeros_like(point)
    for i in range(3):
        c = cross(v[:, (i + 1) % 3] - point, v[:, (i + 2) % 3] - point)
        acc = acc + (0.5 * torch.sqrt(dot(c, c)) / a)[:, None] * ns[:, i]
    return unit(acc)


def hemisphere(face_n, u_phi, cos_t):
    """Direction of (phi = 2 pi u_phi, cos theta) about +z, turned by the
    shortest rotation from +z to face_n (-I when face_n = -z)."""
    phi = 2.0 * math.pi * u_phi
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    vx, vy, vz = sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t
    w, x, y = 1.0 + face_n[:, 2], -face_n[:, 1], face_n[:, 0]
    qn2 = w * w + x * x + y * y
    flip = qn2 <= 1e-12
    qn = torch.sqrt(torch.where(flip, torch.ones_like(qn2), qn2))
    w, x, y = w / qn, x / qn, y / qn
    r = torch.stack([(1 - 2 * y * y) * vx + (2 * x * y) * vy + (2 * y * w) * vz,
                     (2 * x * y) * vx + (1 - 2 * x * x) * vy + (-2 * x * w) * vz,
                     (-2 * y * w) * vx + (2 * x * w) * vy + (1 - 2 * (x * x + y * y)) * vz], -1)
    return unit(torch.where(flip[:, None], -torch.stack([vx, vy, vz], -1), r))


def light_sample(sc, point, u_pick, r1, r2):
    """(light triangle, its selection probability, unit direction to a
    sqrt-barycentric point on it) of an area-weighted emitter pick."""
    e = torch.clamp(torch.searchsorted(sc["e_cdf"], u_pick.contiguous(), side="left"),
                    max=sc["e_idx"].shape[0] - 1)
    tri, p_sel = sc["e_idx"][e], sc["e_p"][e]
    v = sc["v"][tri]
    sq, r2 = torch.sqrt(r1)[:, None], r2[:, None]
    target = (1.0 - sq) * v[:, 0] + sq * (1.0 - r2) * v[:, 1] + r2 * sq * v[:, 2]
    return tri, p_sel, unit(target - point)


def shadow_ray(sc, point, shade_n, u_pick, r1, r2):
    """(light triangle, its selection probability, visible, cos at the
    surface, cos at the light, distance (1 where not visible)) of one light
    sample per lane, traced by a shadow ray."""
    tri, p_sel, to_light = light_sample(sc, point, u_pick, r1, r2)
    cos_t = dot(shade_n, to_light)
    t, hit_tri, hit_p, hit = closest_hit(sc, point, to_light)
    cos_tp = -dot(shading_normal(sc, tri, hit_p), to_light)
    ok = (cos_t >= 0) & hit & (cos_tp >= 0) & (hit_tri == tri)
    return tri, p_sel, ok, cos_t, cos_tp, torch.where(ok, t, torch.ones_like(t))


def render(sc, kd, key: int, idx, width: int, height: int, spp: int, bounces: int,
           p_rr: float):
    """Radiance (n, 3) of global samples idx under `key`, and the path
    segments and shadow rays (n,) int64 each traced.  Differentiable in kd
    (nT, 3)."""
    n, dev = idx.shape[0], idx.device
    dt = sc["planes"].dtype
    h = rng.sample_hash(key, idx)
    jit = rng.uniforms(key, h, 0, (6, 7)).to(dt)
    d = camera(sc, width, height, spp, idx, jit[0], jit[1])
    p = torch.zeros_like(d)
    _, tri, point, hit = closest_hit(sc, p, d)
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    segs = torch.zeros(n, dtype=torch.int64, device=dev)
    shadows = torch.zeros_like(segs)
    lanes = torch.arange(n, device=dev)
    l_e = l_d = torch.zeros((n, 3), dtype=dt, device=dev)
    pm = torch.ones((n, 3), dtype=dt, device=dev)
    for b in range(bounces):
        if lanes.numel() == 0:
            break
        segs[lanes] += 1
        miss = ~hit
        if bool(miss.any()):  # (Q2): an escaping ray adds its stale light and ends
            rad = rad.index_add(0, lanes[miss], pm[miss] * (l_e[miss] + l_d[miss]))
        keep = torch.nonzero(hit).squeeze(1)
        lanes, tri, point, pm = lanes[keep], tri[keep], point[keep], pm[keep]
        d, l_e, l_d = d[keep], l_e[keep], l_d[keep]
        if lanes.numel() == 0:
            break
        u = rng.uniforms(key, h[lanes], b, range(6)).to(dt)
        shadows[lanes] += 1
        if b == 0:
            l_e = sc["emission"][tri]  # (Q1): kept and re-added at every bounce
        kd_t = kd[tri]
        shade_n = shading_normal(sc, tri, point)
        e_tri, p_sel, ok, cos_t, cos_tp, st = shadow_ray(sc, point, shade_n, u[0], u[1], u[2])
        geo = cos_t * cos_tp / st**2 / p_sel
        zero = torch.zeros_like(l_e)
        nee = torch.where(ok[:, None], sc["emission"][e_tri] * geo[:, None], zero)
        l_d = torch.where(ok[:, None], kd_t * nee, zero)
        rad = rad.index_add(0, lanes, pm * (l_e + l_d))
        cont = u[3] < p_rr
        next_d = hemisphere(sc["fn"][tri], u[4], torch.sqrt(u[5]))
        f = kd_t * INV_PI * (dot(next_d, shade_n) * (math.pi / p_rr))[:, None]
        keep = torch.nonzero(cont).squeeze(1)
        lanes, pm, l_e, l_d, d = lanes[keep], (pm * f)[keep], l_e[keep], l_d[keep], next_d[keep]
        _, tri, point, hit = closest_hit(sc, point[keep], d)
    return rad, segs, shadows


def tonemap(rad, spp: int):
    """(H*W*spp, 3) radiance -> (H*W, 3): the mean over samples, x/(1+x)."""
    m = rad.reshape(-1, spp, 3).mean(dim=1)
    return m / (1.0 + m)


def recover_steps(sc, targets, keys, lr: float, width: int, height: int, spp: int,
                  bounces: int, p_rr: float, pixels_per_chunk: int = 1 << 15):
    """Batched recovery from theta = 0 (Kd = sigmoid(theta) = 0.5): per step
    i, scene j's loss mean |tonemap(render(sigmoid(theta_j), keys[i][j])) -
    target_j| and its gradient, then one Adam step (b1 0.9, b2 0.999, eps
    1e-8, eps outside the root).  Returns per step the losses (S,) and the
    gradients (S, nT, 3), and theta after the last step, and the shadow
    rays of every step's renders."""
    s, n_tri = targets.shape[0], sc["planes"].shape[0]
    dev, dt = targets.device, sc["planes"].dtype
    theta = torch.zeros((s, n_tri, 3), dtype=dt, device=dev)
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    n_pix = width * height
    out = []
    for i, step_keys in enumerate(keys):
        grads = torch.zeros_like(theta)
        losses = torch.zeros(s, dtype=torch.float64, device=dev)
        hits = 0
        for j in range(s):
            th = theta[j].clone().requires_grad_()
            tgt = targets[j].reshape(-1, 3).to(dt)
            for lo in range(0, n_pix, pixels_per_chunk):
                hi = min(lo + pixels_per_chunk, n_pix)
                idx = torch.arange(lo * spp, hi * spp, dtype=torch.int64, device=dev)
                rad, _, sh = render(sc, torch.sigmoid(th), step_keys[j], idx, width, height, spp, bounces, p_rr)
                part = (tonemap(rad, spp) - tgt[lo:hi]).abs().sum() / (n_pix * 3)
                part.backward()
                losses[j] += float(part.detach())
                hits += int(sh.sum())
            grads[j] = th.grad
        t = i + 1
        m = m * 0.9 + (1 - 0.9) * grads
        v = v * 0.999 + (1 - 0.999) * grads * grads
        denom = torch.sqrt(v) / math.sqrt(1 - 0.999**t) + 1e-8
        theta = theta - (lr / (1 - 0.9**t)) * m / denom
        out.append(dict(losses=losses, grads=grads, hits=hits))
    return out, theta


def extract(sc, image_flat, key: int, width: int, height: int, spp: int, bounces: int,
            p_rr: float, samples_per_chunk: int = 1 << 21):
    """The transport graph of all W*H*spp samples (the upstream's
    createGraph, inv_path_trace.cu): edges dst <- src of every path vertex
    and every visible light sample accumulate, in float64, per (dst, src)
    bin (the eye is node nT): w, w*f, w*f*pixel(3), w*f*light(3), 1, with
    f = 1 on indirect edges and 1/pi on light edges.  The camera draws under
    fold_in(key, CAMERA_STREAM).  Returns (w (nT+1, nT) row-normalised
    log(1 + max(w_sum, 0)), pixel (nT+1, nT, 3), light (nT+1, nT, 3)), the
    edges counted in each bin (nT+1, nT), and the shadow rays traced."""
    n_tri, dev = sc["planes"].shape[0], image_flat.device
    dt = sc["planes"].dtype
    grid = torch.zeros(((n_tri + 1) * n_tri, 9), dtype=torch.float64, device=dev)
    cam_key = rng.fold_in(key, rng.CAMERA_STREAM)
    total, hits = width * height * spp, 0
    image = image_flat.to(dt)

    def add(dst, src, w, f0, pix, light):
        wf = (w * f0)[:, None]
        light_cols = torch.zeros_like(pix) if light is None else wf * light
        vals = torch.cat([w[:, None], wf, wf * pix, light_cols, torch.ones_like(wf)], 1)
        grid.index_add_(0, dst * n_tri + src, vals.double())

    for lo in range(0, total, samples_per_chunk):
        idx = torch.arange(lo, min(lo + samples_per_chunk, total), dtype=torch.int64, device=dev)
        hc = rng.sample_hash(cam_key, idx)
        jit = rng.uniforms(cam_key, hc, 0, (6, 7)).to(dt)
        ray_d = camera(sc, width, height, spp, idx, jit[0], jit[1])
        ray_p = torch.zeros_like(ray_d)
        h = rng.sample_hash(key, idx)
        pix = image[torch.clamp(idx // spp, 0, width * height - 1)]
        weight = torch.ones(idx.shape[0], dtype=dt, device=dev)
        dst = torch.full_like(idx, n_tri)
        lanes = torch.arange(idx.shape[0], device=dev)
        for b in range(bounces):
            if lanes.numel() == 0:
                break
            _, src, point, hit = closest_hit(sc, ray_p, ray_d)
            keep = torch.nonzero(hit).squeeze(1)
            lanes, src, point, weight = lanes[keep], src[keep], point[keep], weight[keep]
            ray_d, dst = ray_d[keep], dst[keep]
            if lanes.numel() == 0:
                break
            p_l = pix[lanes]
            add(dst, src, weight, torch.ones_like(weight), p_l, None)
            u = rng.uniforms(key, h[lanes], b, range(7)).to(dt)
            shade_n = shading_normal(sc, src, point)
            e_tri, p_sel, ok, cos_t, cos_tp, st = shadow_ray(sc, point, shade_n, u[1], u[2], u[3])
            hits += lanes.numel()
            nee_w = weight * cos_t * cos_tp / (st * st) / p_sel
            sel = torch.nonzero(ok).squeeze(1)
            add(src[sel], e_tri[sel], nee_w[sel], torch.full_like(nee_w[sel], INV_PI), p_l[sel],
                sc["emission"][e_tri[sel]])
            cont = u[4] < p_rr
            next_d = hemisphere(sc["fn"][src], u[5], torch.pow(u[6], torch.full_like(u[6], 0.5)))
            cosine = dot(next_d, shade_n)
            pdf = torch.full_like(cosine, INV_PI)
            w_next = weight * cosine / pdf / p_rr / torch.ones_like(pdf)
            keep = torch.nonzero(cont).squeeze(1)
            lanes, ray_p, ray_d = lanes[keep], point[keep], next_d[keep]
            weight, dst = w_next[keep], src[keep]
    a = grid.to(torch.float32)
    w = torch.log(torch.clamp(a[:, 0], min=0.0) + 1.0).reshape(n_tri + 1, n_tri)
    f = a[:, 1]
    denom = torch.where(f != 0.0, f, torch.ones_like(f))[:, None]
    pixel = (a[:, 2:5] / denom).reshape(n_tri + 1, n_tri, 3)
    light = (a[:, 5:8] / denom).reshape(n_tri + 1, n_tri, 3)
    row = w.sum(dim=1, keepdim=True)
    w = torch.where(row != 0.0, w / torch.where(row != 0.0, row, torch.ones_like(row)),
                    torch.zeros_like(w))
    return (w, pixel, light), a[:, 8].reshape(n_tri + 1, n_tri), hits

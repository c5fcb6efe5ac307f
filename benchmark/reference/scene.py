"""The reference's scene: its own OBJ and MTL reader, the lat-long sphere
generator, and the derived geometry of the upstream renderer
(scene_basics.h): object transform translate(pos) @ scale(scl), vertex
normals by inv(linear^T), face normal normalize((v1 - v0) x (v2 - v1)),
area |cross| / 2, outward edge planes, emitters by any Ke > 0 picked by
area, and the camera matrix S @ R^T of the default pinhole camera (eye 0,
look +z, up +y, 90 degrees, aspect 1).

Host arithmetic is float64 for the transforms and float32 for the derived
geometry, with numpy, so that the arrays are the ones a renderer of the
upstream's scene files would hold.  Configurations hold diffuse materials
only (no Ks), which is all the reference's tracer implements.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch


BOX_PAD = 1e-3  # each object's box is padded so that rounding never culls a hit


def sphere_obj_text(rings: int, segments: int, radius: float = 0.5, normals: bool = True) -> str:
    """A lat-long sphere as OBJ text: 2 * segments * (rings - 1) triangles,
    with per-vertex normals (v//vn) or without them."""
    verts = [(0.0, radius, 0.0)]
    for r in range(1, rings):
        th = np.pi * r / rings
        for s in range(segments):
            ph = 2.0 * np.pi * s / segments
            verts.append((radius * np.sin(th) * np.cos(ph), radius * np.cos(th),
                          radius * np.sin(th) * np.sin(ph)))
    verts.append((0.0, -radius, 0.0))
    ring = lambda r, s: 2 + (r - 1) * segments + s % segments  # 1-based
    faces = [(1, ring(1, s + 1), ring(1, s)) for s in range(segments)]
    for r in range(1, rings - 1):
        for s in range(segments):
            a, b = ring(r, s), ring(r, s + 1)
            c, d = ring(r + 1, s), ring(r + 1, s + 1)
            faces += [(a, b, d), (a, d, c)]
    last = len(verts)
    faces += [(last, ring(rings - 1, s), ring(rings - 1, s + 1)) for s in range(segments)]
    out = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    if normals:
        out += [f"vn {x / radius:.9g} {y / radius:.9g} {z / radius:.9g}" for x, y, z in verts]
        out += ["f " + " ".join(f"{i}//{i}" for i in f) for f in faces]
    else:
        out += ["f " + " ".join(str(i) for i in f) for f in faces]
    return "\n".join(out) + "\n"


def read_mtl(path: str) -> Dict[str, Dict[str, tuple]]:
    """{material name: {"Kd": rgb, "Ke": rgb, "Ks": rgb}} of an MTL file."""
    mats: Dict[str, Dict[str, tuple]] = {}
    cur = None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = mats.setdefault(parts[1], {})
            elif cur is not None and parts[0] in ("Kd", "Ke", "Ks"):
                cur[parts[0]] = tuple(float(x) for x in parts[1:4])
    return mats


def read_obj(path: str):
    """(vertices (nV, 3) float32, normals (nN, 3) float32, faces (nF, 3),
    face normal indices (nF, 3) or None, material name per face) of an
    OBJ made of triangles, 1-based indices."""
    verts, norms, faces, fnorms, names = [], [], [], [], []
    cur = None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "usemtl":
                cur = parts[1]
            elif parts[0] == "f":
                corners = [c.split("/") for c in parts[1:]]
                if len(corners) != 3:
                    raise ValueError(f"{path}: only triangles are read, got {line.strip()!r}")
                faces.append([int(c[0]) - 1 for c in corners])
                fnorms.append([int(c[2]) - 1 if len(c) >= 3 and c[2] else -1 for c in corners])
                names.append(cur)
    fn = np.asarray(fnorms, dtype=np.int64)
    use_vn = len(norms) == len(verts) and len(norms) > 0 and bool((fn >= 0).all())
    return (np.asarray(verts, dtype=np.float32), np.asarray(norms, dtype=np.float32).reshape(-1, 3),
            np.asarray(faces, dtype=np.int64), fn if use_vn else None, names)


def _unit_rows(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(n > 0, v / np.where(n > 0, n, 1.0), 0.0)


def camera_m33() -> np.ndarray:
    """S @ R^T of the default camera: rows (s, u, f) of look +z, up +y."""
    f = np.array([0.0, 0.0, 1.0])
    up = np.array([0.0, 1.0, 0.0])
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    u = u / np.linalg.norm(u)
    ha = math.pi * 90.0 / 360.0
    return (np.diag([math.tan(ha), math.tan(ha), 1.0]) @ np.stack([s, u, f]).T).astype(np.float32)


def object_file(obj: dict, asset_root: str, gen_dir: str) -> str:
    """The OBJ path of a configuration's object: an asset, or the generated
    sphere written once to `gen_dir` (a raw file that both sides read)."""
    if "sphere" not in obj:
        return os.path.join(asset_root, obj["obj"])
    sp = obj["sphere"]
    path = os.path.join(gen_dir, f"sphere_{sp['rings']}x{sp['segments']}.obj")
    text = sphere_obj_text(sp["rings"], sp["segments"], sp.get("radius", 0.5),
                           sp.get("normals", True))
    if not os.path.exists(path) or open(path).read() != text:
        os.makedirs(gen_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return path


def build(objects: List[dict], asset_root: str, gen_dir: str) -> Dict[str, torch.Tensor]:
    """The scene of a configuration's objects, as CPU tensors: v (nT, 3, 3),
    vn (nT, 3, 3) or None, fn (nT, 3), area (nT,), planes (nT, 16) [n, -c.n,
    out_j, d_j], kd, emission (nT, 3), e_idx, e_p, e_cdf, m33, and each
    object's triangle rows (G, 2) and padded box (G, 6) [lo xyz, hi xyz]."""
    tris, tri_ns, kds, kes, groups = [], [], [], [], []
    for obj in objects:
        verts, norms, faces, fn_idx, names = read_obj(object_file(obj, asset_root, gen_dir))
        mats = read_mtl(os.path.join(asset_root, obj["mtl"])) if "mtl" in obj else {}
        linear = np.diag(np.asarray(obj.get("scl", (1, 1, 1)), dtype=np.float64))
        v = verts.astype(np.float64) @ linear.T + np.asarray(obj["pos"], dtype=np.float64)
        tri = v[faces].astype(np.float32)
        if fn_idx is not None:
            vn = norms.astype(np.float64) @ np.linalg.inv(linear.T).T
            tri_ns.append(vn[fn_idx].astype(np.float32))
        else:
            tri_ns.append(None)
        tris.append(tri)
        at = sum(t.shape[0] for t in tris[:-1])
        groups.append((at, at + tri.shape[0]))
        for name in names:
            m = mats.get(name, {})
            kds.append(m.get("Kd", obj.get("kd", (0.0, 0.0, 0.0))))
            if any(m.get("Ks", (0.0,)) ):
                raise ValueError("the reference traces diffuse materials only")
            kes.append(m.get("Ke", (0.0, 0.0, 0.0)))
    v32 = np.concatenate(tris).astype(np.float32)
    if all(n is None for n in tri_ns):
        vn = None
    else:
        filled = []
        for t, n in zip(tris, tri_ns):
            if n is None:
                fn = _unit_rows(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 1]))
                n = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
            filled.append(n)
        vn = np.concatenate(filled)
    cross = np.cross(v32[:, 1] - v32[:, 0], v32[:, 2] - v32[:, 1])
    norm = np.linalg.norm(cross, axis=-1, keepdims=True)
    area = (norm[:, 0] / 2.0).astype(np.float32)
    fnorm = np.where(norm > 0, cross / np.where(norm > 0, norm, 1.0), 0.0)
    center = v32.mean(axis=1)
    planes = np.zeros((v32.shape[0], 4, 4), dtype=np.float32)
    planes[:, 0, :3] = fnorm
    planes[:, 0, 3] = -np.sum(center * fnorm, axis=-1)
    for j in range(3):
        s0, s1 = v32[:, j], v32[:, (j + 1) % 3]
        out = _unit_rows(np.cross(s1 - s0, fnorm))
        planes[:, 1 + j, :3] = out
        planes[:, 1 + j, 3] = -np.sum(out * (s1 + s0), axis=-1) / 2.0
    emission = np.asarray(kes, dtype=np.float32)
    e_idx = np.nonzero((emission > 0).any(axis=-1))[0]
    e_area = area[e_idx].astype(np.float32)
    e_p = e_area / e_area.sum()
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    boxes = np.stack([np.concatenate([v32[lo:hi].reshape(-1, 3).min(0) - BOX_PAD,
                                      v32[lo:hi].reshape(-1, 3).max(0) + BOX_PAD])
                      for lo, hi in groups])
    return dict(groups=t(np.asarray(groups), torch.int64), boxes=t(boxes),v=t(v32), vn=None if vn is None else t(vn), fn=t(fnorm), area=t(area),
                planes=t(planes.reshape(-1, 16)), kd=t(np.asarray(kds, dtype=np.float32)),
                emission=t(emission), e_idx=t(e_idx, torch.int64), e_p=t(e_p),
                e_cdf=t(np.cumsum(e_p).astype(np.float32)), m33=t(camera_m33()))

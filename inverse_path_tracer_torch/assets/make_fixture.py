"""Regenerate the scene-0 fixture (Cornell box + cube) from files in the repo.

    python -m inverse_path_tracer_torch.assets.make_fixture

Geometry comes from ``artifacts/graphviz/mesh.ply`` (the 30 faces of scene 0
in global triangle order, in world coordinates) and the per-face Kd from
``artifacts/exp100/data.npz["labels"][0]``.  World coordinates are mapped
back into each object's local frame (scenes/0.txt places the Cornell box at
POS (0,0,4) SCL 2 and the cube at POS (0,-1.5,4)), so that
``load_scene("scenes/0.txt", asset_root=ASSET_ROOT)`` reproduces the
world-space mesh exactly.  Faces 16 and 17 are the ceiling light (Ke 10).
Only numpy is needed.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

N_CORNELL = 18
LIGHT_FACES = (16, 17)
LIGHT_KE = 10.0
CORNELL_POS = np.array([0.0, 0.0, 4.0])
CORNELL_SCL = 2.0
CUBE_POS = np.array([0.0, -1.5, 4.0])


def _read_ply(path):
    with open(path) as f:
        lines = f.read().splitlines()
    n_v = n_f = 0
    for i, line in enumerate(lines):
        parts = line.split()
        if parts[:2] == ["element", "vertex"]:
            n_v = int(parts[2])
        elif parts[:2] == ["element", "face"]:
            n_f = int(parts[2])
        elif line == "end_header":
            body = lines[i + 1 :]
            break
    verts = np.array([[float(x) for x in body[k].split()[:3]] for k in range(n_v)])
    faces = np.array(
        [[int(x) for x in body[n_v + k].split()[1:4]] for k in range(n_f)]
    )
    return verts, faces


def _fmt(x) -> str:
    return np.format_float_positional(np.float32(x), trim="-")


def _obj_text(header, verts_local, faces, face_mats):
    """Triangle OBJ: the object's vertices (1-based, in first-use order) and
    one usemtl line right before each face."""
    used = []
    for f in faces:
        for v in f:
            if v not in used:
                used.append(v)
    local = {v: k + 1 for k, v in enumerate(used)}
    out = [header]
    out += [
        "v " + " ".join(_fmt(c) for c in verts_local[v]) for v in used
    ]
    for f, m in zip(faces, face_mats):
        out.append(f"usemtl {m}")
        out.append("f " + " ".join(str(local[v]) for v in f))
    return "\n".join(out) + "\n"


def sphere_obj_text(rings: int = 8, segments: int = 16, radius: float = 0.5,
                    normals: bool = True) -> str:
    """A lat-long sphere as a triangle OBJ with per-vertex normals (v//vn),
    for smooth-shading checks, or without them (flat shading) when
    normals=False: 2*segments*(rings-1) triangles."""
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


def main() -> None:
    verts, faces = _read_ply(os.path.join(REPO, "artifacts/graphviz/mesh.ply"))
    kd = np.load(os.path.join(REPO, "artifacts/exp100/data.npz"))["labels"][0]
    assert faces.shape == (30, 3) and kd.shape == (30, 3)

    # Cornell materials: one per distinct (Kd, emissive) pair, in face order.
    names, mats, face_mats = {}, [], []
    for i in range(N_CORNELL):
        key = (tuple(np.float32(kd[i]).tolist()), i in LIGHT_FACES)
        if key not in names:
            names[key] = "light" if key[1] else f"wall{len(names)}"
            mats.append((names[key], kd[i], key[1]))
        face_mats.append(names[key])
    mtl = []
    for name, k, emissive in mats:
        mtl.append(f"newmtl {name}")
        mtl.append("Kd " + " ".join(_fmt(c) for c in k))
        if emissive:
            mtl.append(f"Ke {_fmt(LIGHT_KE)} {_fmt(LIGHT_KE)} {_fmt(LIGHT_KE)}")
        mtl.append("")

    header = "# generated by inverse_path_tracer_torch/assets/make_fixture.py"
    cornell = _obj_text(
        header + "\nmtllib CornellBox-Empty-CO.mtl",
        (verts - CORNELL_POS) / CORNELL_SCL,
        faces[:N_CORNELL],
        face_mats,
    )
    cube = _obj_text(
        header, verts - CUBE_POS, faces[N_CORNELL:], ["cube"] * (30 - N_CORNELL)
    )
    with open(os.path.join(HERE, "CornellBox/CornellBox-Empty-CO.obj"), "w") as f:
        f.write(cornell)
    with open(os.path.join(HERE, "CornellBox/CornellBox-Empty-CO.mtl"), "w") as f:
        f.write(header + "\n" + "\n".join(mtl))
    with open(os.path.join(HERE, "shapes/cube.obj"), "w") as f:
        f.write(cube)


if __name__ == "__main__":
    main()

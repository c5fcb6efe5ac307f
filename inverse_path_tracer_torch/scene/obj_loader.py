"""Minimal Wavefront OBJ / MTL loader (host side, numpy).

The subset the reference assets use, with tiny_obj_loader's semantics:

  * OBJ: ``v``, ``vn``, ``f`` (``v``, ``v/vt``, ``v//vn``, ``v/vt/vn``;
    negative indices), ``usemtl``, ``mtllib`` (recorded, not loaded: the
    scene DSL names the MTL).  Quads split along the shortest diagonal
    (tiny_obj_loader.h:204-300), larger polygons fan-triangulate.
  * MTL: ``newmtl``, ``Ka``, ``Kd``, ``Ks``, ``Ke``, ``Kt``/``Tf``, ``Ns``,
    ``Ni``, ``d``, ``illum``, with tiny_obj_loader's defaults.
  * Inline material strings ``*Kd r g b*`` from the scene DSL.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Material:
    name: str = ""
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diffuse: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    transmittance: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    shininess: float = 1.0
    ior: float = 1.0
    dissolve: float = 1.0
    illum: int = 0


def _parse_floats(parts: List[str], n: int) -> Tuple[float, ...]:
    vals = [float(p) for p in parts[:n]]
    while len(vals) < n:
        vals.append(0.0)
    return tuple(vals)


_COLOR_FIELDS = {
    "Ka": "ambient",
    "Kd": "diffuse",
    "Ks": "specular",
    "Ke": "emission",
    "Kt": "transmittance",
    "Tf": "transmittance",
}
_SCALAR_FIELDS = {"Ns": ("shininess", float), "Ni": ("ior", float),
                  "d": ("dissolve", float), "illum": ("illum", int)}


def load_mtl(path: str) -> Dict[str, Material]:
    """Parse an MTL file into {name: Material}."""
    with open(path, "r") as f:
        lines = f.read().splitlines()
    materials: Dict[str, Material] = {}
    cur: Optional[Material] = None
    for raw in lines:
        parts = raw.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        tok = parts[0]
        if tok == "newmtl":
            name = parts[1] if len(parts) > 1 else ""
            cur = Material(name=name)
            materials[name] = cur
        elif cur is None:
            continue
        elif tok in _COLOR_FIELDS:
            setattr(cur, _COLOR_FIELDS[tok], _parse_floats(parts[1:], 3))
        elif tok in _SCALAR_FIELDS:
            field, cast = _SCALAR_FIELDS[tok]
            setattr(cur, field, cast(parts[1]))
    return materials


def parse_inline_material(text: str) -> Material:
    """The scene DSL's inline ``*Kd r g b*`` (only Kd is read, as in
    reference scene_basics.h:251-268)."""
    body = text.strip()
    if body.startswith("*") and body.endswith("*"):
        body = body[1:-1]
    mat = Material(name="<inline>")
    for line in body.split("\n"):
        parts = line.strip().split()
        if parts and parts[0] == "Kd":
            mat.diffuse = _parse_floats(parts[1:], 3)
    return mat


def _resolve_index(idx: int, n: int) -> int:
    """OBJ indices are 1-based; negative indices count from the end."""
    return idx - 1 if idx > 0 else n + idx


@dataclasses.dataclass
class ObjMesh:
    vertices: np.ndarray  # (nV, 3) float32
    normals: np.ndarray  # (nN, 3) float32 (may be empty)
    faces: np.ndarray  # (nF, 3) int32 vertex indices
    face_normals_idx: np.ndarray  # (nF, 3) int32 vn indices, or -1
    material_names: List[Optional[str]]  # per-face usemtl name
    mtllibs: List[str]


def load_obj(path: str) -> ObjMesh:
    with open(path, "r") as f:
        lines = f.read().splitlines()

    verts: List[Tuple[float, float, float]] = []
    norms: List[Tuple[float, float, float]] = []
    faces: List[Tuple[int, int, int]] = []
    fnorm: List[Tuple[int, int, int]] = []
    fmat: List[Optional[str]] = []
    mtllibs: List[str] = []
    cur_mat: Optional[str] = None

    def add(vi, ni, a, b, c):
        faces.append((vi[a], vi[b], vi[c]))
        fnorm.append((ni[a], ni[b], ni[c]))
        fmat.append(cur_mat)

    for raw in lines:
        parts = raw.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        tok = parts[0]
        if tok == "v":
            verts.append(_parse_floats(parts[1:], 3))
        elif tok == "vn":
            norms.append(_parse_floats(parts[1:], 3))
        elif tok == "usemtl":
            cur_mat = parts[1] if len(parts) > 1 else None
        elif tok == "mtllib":
            mtllibs.extend(parts[1:])
        elif tok == "f":
            vi: List[int] = []
            ni: List[int] = []
            for p in parts[1:]:
                comps = p.split("/")
                vi.append(_resolve_index(int(comps[0]), len(verts)))
                if len(comps) >= 3 and comps[2] != "":
                    ni.append(_resolve_index(int(comps[2]), len(norms)))
                else:
                    ni.append(-1)
            if len(vi) == 3:
                add(vi, ni, 0, 1, 2)
            elif len(vi) == 4:
                # Shortest-diagonal split (tiny_obj_loader.h:257-300).
                v = np.asarray(verts, dtype=np.float64)
                e02 = v[vi[2]] - v[vi[0]]
                e13 = v[vi[3]] - v[vi[1]]
                if float(e02 @ e02) < float(e13 @ e13):
                    add(vi, ni, 0, 1, 2)
                    add(vi, ni, 0, 2, 3)
                else:
                    add(vi, ni, 0, 1, 3)
                    add(vi, ni, 1, 2, 3)
            else:
                for k in range(1, len(vi) - 1):
                    add(vi, ni, 0, k, k + 1)

    return ObjMesh(
        vertices=np.asarray(verts, dtype=np.float32).reshape(-1, 3),
        normals=np.asarray(norms, dtype=np.float32).reshape(-1, 3),
        faces=np.asarray(faces, dtype=np.int32).reshape(-1, 3),
        face_normals_idx=np.asarray(fnorm, dtype=np.int32).reshape(-1, 3),
        material_names=fmat,
        mtllibs=mtllibs,
    )

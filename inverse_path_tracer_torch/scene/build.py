"""Scene construction: DSL/OBJ/MTL -> SceneData, a dataclass of flat tensors.

Geometry conventions (reference scene_basics.h, scene.h):
  * object transform T = translate(pos) @ rotate(axis-angle ori) @
    scale(scl); vertices by T, vertex normals by inv(T.linear().T),
    unnormalized;
  * zero ORI => identity rotation;
  * face normal = normalize((v1-v0) x (v2-v1)), area = |cross|/2;
  * emissive rule: any Ke channel > 0; global triangle / emissive indices
    are per-object offsets in object order;
  * camera matrix M33 = S @ R^T (the transpose of the view matrix, so the
    eye position is dropped and origins map as p' = M33 @ p).

The host-side arithmetic (float64 transforms, float32 derived geometry)
repeats the JAX package's so that both give bit-identical scenes.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np
import torch

from inverse_path_tracer_torch.config import CameraConfig
from inverse_path_tracer_torch.scene import obj_loader
from inverse_path_tracer_torch.scene.dsl import ObjectParams, load_params

if TYPE_CHECKING:
    from inverse_path_tracer_torch.ops.bvh import BVHData

ASSET_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets"
)
# Cube Kd of the reference's scene 0, with which artifacts/bench_golden_0.png
# was rendered (scenes/0.txt in this repo carries a different cube Kd).
REFERENCE_CUBE_KD = (0.9041462985304743, 0.5854651848798454, 0.007022117649276849)


@dataclasses.dataclass
class SceneData:
    """Flat SoA scene.  float32 unless noted; nT triangles, nE emitters."""

    vertices: torch.Tensor  # (nT, 3, 3) [tri, corner, xyz]
    # (nT, 3, 3) per-corner shading normals, or (nT, 0, 3) when no object
    # has vertex normals (flat shading: the normal is the face normal).
    vertex_normals: torch.Tensor
    face_normal: torch.Tensor  # (nT, 3)
    center: torch.Tensor  # (nT, 3)
    area: torch.Tensor  # (nT,)
    edge_out: torch.Tensor  # (nT, 3, 3) outward edge-plane normals
    edge_d: torch.Tensor  # (nT, 3) edge-plane offsets
    diffuse: torch.Tensor  # (nT, 3) default Kd (the learnable materials)
    specular: torch.Tensor  # (nT, 3)
    emission: torch.Tensor  # (nT, 3)
    shininess: torch.Tensor  # (nT,)
    emissive_idx: torch.Tensor  # (nE,) int64 global triangle index
    emissive_p: torch.Tensor  # (nE,) selection prob = area / sum(area)
    emissive_cdf: torch.Tensor  # (nE,) inclusive cumsum of emissive_p
    specular_idx: torch.Tensor  # (nS,) int64 triangles with any Ks > 0
    cam_m33: torch.Tensor  # (3, 3) ray transform
    # (4, 4*nT) packed plane equations: column 4t+j is plane j of triangle
    # t, [n, -c.n] for j=0 and [out_{j-1}, d_{j-1}] for the edge planes.
    plane_mat: torch.Tensor
    # The optional BVH over the triangles in global order (ops/bvh.py
    # attach_bvh, load_scene(with_bvh=True)), for ops/bvh.py intersect_bvh.
    # The renders do not read it: the kernels sweep every triangle.
    bvh: Optional["BVHData"] = None

    @property
    def n_tri(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_emissive(self) -> int:
        return self.emissive_idx.shape[0]

    @property
    def has_vertex_normals(self) -> bool:
        return self.vertex_normals.shape[1] != 0

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def to(self, device) -> "SceneData":
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            moved[f.name] = None if v is None else v.to(device)
        return SceneData(**moved)

    def replace(self, **changes) -> "SceneData":
        return dataclasses.replace(self, **changes)


def _axis_angle_matrix(ori: Sequence[float]) -> np.ndarray:
    """Rodrigues rotation for axis-angle vector `ori` (angle = |ori|)."""
    ori = np.asarray(ori, dtype=np.float64)
    angle = float(np.linalg.norm(ori))
    if angle == 0.0:
        return np.eye(3)
    axis = ori / angle
    k = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * (k @ k)


def _normalize_or_zero(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(n > 0, v / np.where(n > 0, n, 1.0), 0.0)


def camera_matrix(cam: CameraConfig) -> np.ndarray:
    """M33 = S3 @ R^T with R rows (s, u, f) (reference scene.h:49-77)."""

    def unit(v):
        v = np.asarray(v, dtype=np.float64)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    f = unit(cam.look)
    up = unit(cam.up)
    s = unit(np.cross(f, up))
    u = unit(np.cross(s, f))
    r = np.stack([s, u, f], axis=0)
    ha = math.pi * cam.height_angle_deg / 360.0
    s3 = np.diag([math.tan(ha), math.tan(ha * cam.aspect_ratio), 1.0])
    return (s3 @ r.T).astype(np.float32)


def _resolve_path(path: str, asset_root: Optional[str]) -> str:
    if os.path.isabs(path) or asset_root is None:
        return path
    return os.path.normpath(os.path.join(asset_root, path))


@dataclasses.dataclass
class _HostMesh:
    vertices: np.ndarray  # (t, 3, 3)
    vertex_normals: np.ndarray  # (t, 3, 3) or (t, 0, 3)
    diffuse: np.ndarray
    specular: np.ndarray
    emission: np.ndarray
    shininess: np.ndarray


def _build_object(obj: ObjectParams, asset_root: Optional[str]) -> _HostMesh:
    mesh = obj_loader.load_obj(_resolve_path(obj.obj_file, asset_root))
    if obj.mtl_file.strip().startswith("*"):
        materials = {}
        default_mat = obj_loader.parse_inline_material(obj.mtl_file)
    else:
        materials = obj_loader.load_mtl(_resolve_path(obj.mtl_file, asset_root))
        default_mat = obj_loader.Material(name="<default>")

    rot = _axis_angle_matrix(obj.ori)
    linear = rot @ np.diag(np.asarray(obj.scl, dtype=np.float64))
    trans = np.asarray(obj.pos, dtype=np.float64)
    normal_xf = np.linalg.inv(linear.T)

    v = mesh.vertices.astype(np.float64) @ linear.T + trans
    t = mesh.faces.shape[0]
    tri_v = v[mesh.faces]  # (t, 3, 3)
    # Per-corner normals only when the OBJ supplies a full normal set
    # (reference scene_basics.h:176-181).
    use_vn = (
        mesh.normals.shape[0] == v.shape[0]
        and mesh.normals.size > 0
        and np.all(mesh.face_normals_idx >= 0)
    )
    if use_vn:
        vn = mesh.normals.astype(np.float64) @ normal_xf.T
        tri_n = vn[mesh.face_normals_idx]
    else:
        tri_n = np.zeros((t, 0, 3))

    diffuse = np.zeros((t, 3))
    specular = np.zeros((t, 3))
    emission = np.zeros((t, 3))
    shininess = np.ones((t,))
    for i, name in enumerate(mesh.material_names):
        m = materials.get(name, default_mat) if name is not None else default_mat
        diffuse[i] = m.diffuse
        specular[i] = m.specular
        emission[i] = m.emission
        shininess[i] = m.shininess

    f32 = lambda a: a.astype(np.float32)
    return _HostMesh(f32(tri_v), f32(tri_n), f32(diffuse), f32(specular),
                     f32(emission), f32(shininess))


def build_scene(
    objects: List[ObjectParams],
    camera: CameraConfig = CameraConfig(),
    asset_root: Optional[str] = None,
) -> SceneData:
    """Assemble a (CPU) SceneData from object params, objects concatenated
    in order."""
    meshes = [_build_object(o, asset_root) for o in objects]
    vertices = np.concatenate([m.vertices for m in meshes], axis=0)
    # Flat objects in a scene that has vertex normals get their face normal
    # at each corner (reference scene_basics.h:93-95).
    if all(m.vertex_normals.shape[1] == 0 for m in meshes):
        vertex_normals = np.zeros((vertices.shape[0], 0, 3), dtype=np.float32)
    else:
        filled = []
        for m in meshes:
            if m.vertex_normals.shape[1] == 0:
                fn = _normalize_or_zero(
                    np.cross(m.vertices[:, 1] - m.vertices[:, 0],
                             m.vertices[:, 2] - m.vertices[:, 1])
                )
                filled.append(np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32))
            else:
                filled.append(m.vertex_normals)
        vertex_normals = np.concatenate(filled, axis=0)
    diffuse = np.concatenate([m.diffuse for m in meshes], axis=0)
    specular = np.concatenate([m.specular for m in meshes], axis=0)
    emission = np.concatenate([m.emission for m in meshes], axis=0)
    shininess = np.concatenate([m.shininess for m in meshes], axis=0)

    # Derived geometry in float32 (reference scene_basics.h:80-95, 497-503).
    v32 = vertices.astype(np.float32)
    cross = np.cross(v32[:, 1] - v32[:, 0], v32[:, 2] - v32[:, 1])
    norm = np.linalg.norm(cross, axis=-1, keepdims=True)
    area = (norm[:, 0] / 2.0).astype(np.float32)
    face_normal = np.where(norm > 0, cross / np.where(norm > 0, norm, 1.0), 0.0)
    center = v32.mean(axis=1)

    # Edge planes: a point is inside iff point.out_j + d_j <= 0 for all j.
    edge_out = np.zeros_like(vertices, dtype=np.float32)
    edge_d = np.zeros((vertices.shape[0], 3), dtype=np.float32)
    for j in range(3):
        s0 = v32[:, j]
        s1 = v32[:, (j + 1) % 3]
        out = _normalize_or_zero(np.cross(s1 - s0, face_normal))
        edge_out[:, j] = out
        edge_d[:, j] = -np.sum(out * (s1 + s0), axis=-1) / 2.0

    n_t = vertices.shape[0]
    planes = np.zeros((n_t, 4, 4), dtype=np.float32)
    planes[:, 0, :3] = face_normal
    planes[:, 0, 3] = -np.sum(center * face_normal, axis=-1)
    for j in range(3):
        planes[:, 1 + j, :3] = edge_out[:, j]
        planes[:, 1 + j, 3] = edge_d[:, j]
    plane_mat = np.ascontiguousarray(planes.transpose(2, 0, 1).reshape(4, 4 * n_t))

    emissive_idx = np.nonzero((emission > 0).any(axis=-1))[0]
    specular_idx = np.nonzero((specular > 0).any(axis=-1))[0]
    e_area = area[emissive_idx].astype(np.float32)
    emissive_p = e_area / e_area.sum() if emissive_idx.size else e_area
    emissive_cdf = np.cumsum(emissive_p).astype(np.float32)

    t32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    t64 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))
    return SceneData(
        vertices=t32(vertices),
        vertex_normals=t32(vertex_normals),
        face_normal=t32(face_normal),
        center=t32(center),
        area=t32(area),
        edge_out=t32(edge_out),
        edge_d=t32(edge_d),
        diffuse=t32(diffuse),
        specular=t32(specular),
        emission=t32(emission),
        shininess=t32(shininess),
        emissive_idx=t64(emissive_idx),
        emissive_p=t32(emissive_p),
        emissive_cdf=t32(emissive_cdf),
        specular_idx=t64(specular_idx),
        cam_m33=t32(camera_matrix(camera)),
        plane_mat=t32(plane_mat),
    )


def load_scene(
    scenefile: str,
    camera: CameraConfig = CameraConfig(),
    asset_root: Optional[str] = None,
    with_bvh: bool = False,
) -> SceneData:
    """Load a scene DSL file.  asset_root defaults to the parent of the scene
    file's directory (scene files live in `scenes/`); with_bvh attaches the
    scene's BVH (ops/bvh.py attach_bvh)."""
    if asset_root is None:
        asset_root = os.path.dirname(os.path.dirname(os.path.abspath(scenefile)))
    scene = build_scene(load_params(scenefile), camera=camera, asset_root=asset_root)
    if with_bvh:
        from inverse_path_tracer_torch.ops.bvh import attach_bvh

        scene = attach_bvh(scene)
    return scene

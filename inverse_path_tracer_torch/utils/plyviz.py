"""Transport-graph and scene-mesh PLY writers (the counterpart of the JAX
package's utils/plyviz.py, byte for byte the same files).

The reference commits two Open3D views by hand, mesh.ply (a coloured
Cornell mesh) and lines.ply (the transport graph as a coloured line set);
here `cli.py graph-viz` writes them.  Files are ASCII PLY 1.0 with the
reference artifacts' element and property layout (vertex xyz [+rgb], edge
vertex1/vertex2/rgb, face vertex_indices), loadable by Open3D, meshlab or
trimesh.  Every argument may be a tensor (on any device) or an array.
"""

from __future__ import annotations

import numpy as np
import torch


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _write_ply(path: str, header_lines, body_lines) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        # The JAX package's comment line, so that both writers' files match.
        f.write("comment inverse_path_tracer_tpu graph-viz\n")
        for h in header_lines:
            f.write(h + "\n")
        f.write("end_header\n")
        for b in body_lines:
            f.write(b + "\n")


def write_mesh_ply(scene, materials, path: str) -> None:
    """Coloured scene mesh: deduplicated vertices (rounded to 1e-6) with
    uchar RGB, faces as index lists.  A vertex takes the diffuse albedo of
    the last triangle that touches it (a per-face colour baked to
    vertices)."""
    v = _np64(scene.vertices).reshape(-1, 3)
    mats = np.clip(_np64(materials), 0.0, 1.0)
    uv, inv = np.unique(v.round(6), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    col = np.zeros((uv.shape[0], 3))
    for t in range(faces.shape[0]):
        col[faces[t]] = mats[t]
    col8 = (col * 255).astype(np.uint8)

    header = [
        f"element vertex {uv.shape[0]}",
        "property double x",
        "property double y",
        "property double z",
        "property uchar red",
        "property uchar green",
        "property uchar blue",
        f"element face {faces.shape[0]}",
        "property list uchar uint vertex_indices",
    ]
    body = [
        f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}"
        for p, c in zip(uv, col8)
    ] + [f"3 {a} {b} {c}" for a, b, c in faces]
    _write_ply(path, header, body)


def write_graph_ply(scene, w, path: str, p_min: float = 1e-3) -> int:
    """The transport graph as a coloured line set: one node per triangle at
    its centroid, one edge per entry of w[:nT] above p_min (reference
    ipt.py:26, 70), coloured from blue (weak) to red (the strongest).  `w`
    is the (nT+1, nT) weight grid of extract_graph; its eye row is left out,
    as in the reference artifact.  Returns the edge count."""
    cent = _np64(scene.vertices).mean(axis=1)
    n_tri = cent.shape[0]
    wt = _np64(w)[:n_tri]
    wt = np.where(wt > p_min, wt, 0.0)
    dst, src = np.nonzero(wt)
    vals = wt[dst, src]
    t = vals / vals.max() if vals.size else vals
    col8 = np.stack([t * 255, np.zeros_like(t), (1.0 - t) * 255], axis=-1).astype(np.uint8)

    header = [
        f"element vertex {n_tri}",
        "property double x",
        "property double y",
        "property double z",
        f"element edge {dst.shape[0]}",
        "property int vertex1",
        "property int vertex2",
        "property uchar red",
        "property uchar green",
        "property uchar blue",
    ]
    body = [f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}" for p in cent] + [
        f"{d} {s} {c[0]} {c[1]} {c[2]}" for d, s, c in zip(dst, src, col8)
    ]
    _write_ply(path, header, body)
    return int(dst.shape[0])


def read_ply_counts(path: str) -> dict:
    """{element: declared count} of an ASCII PLY file; raises ValueError when
    the header is not PLY or the body's line count differs from the sum of
    the counts."""
    with open(path) as f:
        lines = f.read().splitlines()
    if len(lines) < 2 or lines[0] != "ply" or not lines[1].startswith("format ascii"):
        raise ValueError(f"{path} is not an ASCII PLY file")
    counts = {}
    i = 2
    while lines[i] != "end_header":
        if lines[i].startswith("element"):
            _, name, n = lines[i].split()
            counts[name] = int(n)
        i += 1
    body = [ln for ln in lines[i + 1 :] if ln.strip()]
    if len(body) != sum(counts.values()):
        raise ValueError(f"{path}: {len(body)} body lines for the element counts {counts}")
    return counts

"""The kernels' Morton order (ops/kernels/clusters.py morton_order): a numpy
float32 reference and a vertex set crafted where its rounding shows.  Shared
by the CPU tests (tests/test_torch_cluster.py, against the JAX package) and
the card's (tests/test_torch_cuda.py, which imports no JAX).

The reference is the JAX package's _morton_order written out in numpy: the
centroid is the vertex sum (v0 + v1) + v2 times float32(1/3), as XLA
computes the package's mean; divide=True takes the sum / 3 instead, which
rounds differently on some sums (crafted_vertices holds such sums).
"""

import numpy as np

F = np.float32
THIRD = F(1) / F(3)


def _expand_bits(v: np.ndarray) -> np.ndarray:
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def centroids(v: np.ndarray, divide: bool = False) -> np.ndarray:
    s = (v[:, 0] + v[:, 1]) + v[:, 2]
    return s / F(3) if divide else s * THIRD


def reference_order(vertices: np.ndarray, hot: int, divide: bool = False) -> np.ndarray:
    """(nT,) int64 internal -> global order of vertices (nT, 3, 3)."""
    v = np.asarray(vertices, dtype=F)
    cent = centroids(v, divide)
    lo = cent.min(axis=0)
    ext = cent.max(axis=0) - lo
    inv_ext = F(1) / np.where(ext > 0, ext, F(1))
    q = np.clip(((cent - lo) * inv_ext * F(1024)).astype(np.int32), 0, 1023).astype(np.int64)
    codes = _expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1) | (_expand_bits(q[:, 2]) << 2)
    codes = np.clip(codes, 0, (1 << 30) - 1)
    if hot <= 0:
        return np.argsort(codes, kind="stable")
    dv = v.max(axis=1) - v.min(axis=1)
    size = (dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]) + dv[:, 2] * dv[:, 2]
    rank = np.argsort(np.argsort(-size, kind="stable"), kind="stable")
    key = np.where(rank < hot, rank, (1 << 30) + codes)
    return np.argsort(key, kind="stable")


def crafted_vertices(seed: int = 7) -> np.ndarray:
    """(nT, 3, 3) float32 triangles, every vertex at z = 5 (the z axis has
    zero extent), the centroids' x from 0 to 1024 exactly (point triangles at
    both ends), so that a centroid's x cell is its integer part:
      * random small triangles,
      * for several k, a triangle whose vertex sum is the float32 just below
        3k: its sum / 3 lies in cell k - 1, its sum * float32(1/3) in cell
        k; beside it triangles with centroids k - 0.5 and k + 0.5,
      * duplicate centroids: exact copies of random triangles (ties of code
        and size), and three shapes with the centroid (502, 2, 5), one of
        them a point (size 0)."""
    g = np.random.default_rng(seed)
    n = 200
    base = np.stack([g.uniform(4, 1020, n), g.uniform(-4, 4, n), np.full(n, 5.0)], axis=1)
    off = g.uniform(-2, 2, (n, 3, 3))
    off[..., 2] = 0
    tris = [(base[:, None, :] + off).astype(F)]
    tris.append(tris[0][[3, 17, 17, 42, 99]])
    point = lambda x, y: np.array([[x, y, 5]] * 3, F)
    tris.append(np.stack([point(0, 0), point(1024, 0), point(502, 2),
                          np.array([[500, 0, 5], [506, 0, 5], [500, 6, 5]], F),
                          np.array([[501, 1, 5], [502, 2, 5], [503, 3, 5]], F)]))
    below = lambda k: np.nextafter(F(3 * k), F(0))
    split_k = [k for k in range(1, 1024) if np.floor(below(k) / F(3)) != np.floor(below(k) * THIRD)]
    for k in split_k[::40]:
        s = below(k)
        tri = np.array([[s - 2 * k, 0.25, 5], [k, 0.25, 5], [k, 0.25, 5]], F)
        tris.append(np.stack([tri, point(k - 0.5, 0.25), point(k + 0.5, 0.25)]))
    v = np.concatenate(tris)
    cent = centroids(v)
    assert cent[:, 0].min() == 0 and cent[:, 0].max() == 1024 and np.ptp(cent[:, 2]) == 0
    split = np.floor(centroids(v, divide=True)[:, 0]) != np.floor(cent[:, 0])
    assert split.sum() == len(split_k[::40]) >= 8
    return v

"""The yardstick of the roofline shares: the H100's published peaks and a
job's least work.  The least work is what any correct implementation of
the estimator must do for the job, never what one implementation counts:

  * operations: 13 float32 operations per hit (the one ray-triangle test
    that finds it: two dot products and a divide), hits being the shadow
    rays, one per path vertex that hit a surface;
  * bytes: the job's inputs read once and its outputs written once.

The least time is the larger of operations / peak FLOP/s and bytes / peak
bytes/s."""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12  # NVIDIA H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
OPS_PER_HIT = 13


def least_seconds(hits: float, nbytes: float) -> float:
    return max(OPS_PER_HIT * hits / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def scene_bytes(n_tri: int, vertex_normals: bool) -> int:
    """The scene a job reads once: corners (9 floats), corner normals (9
    when the scene has them) and emission (3) per triangle."""
    return 4 * n_tri * (9 + (9 if vertex_normals else 0) + 3)

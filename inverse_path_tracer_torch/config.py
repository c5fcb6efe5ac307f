"""Static render configuration (the fields of the JAX package's
RenderConfig / CameraConfig that the forward and inverse paths read) and
the training schedule TrainConfig (the JAX package's, field for field).

wavefront, stage_bounces, cluster_k, tri_order, bin_cells and intersect
keep the JAX package's meanings (its config.py:110-207).  Its TPU measurement gates
stage_loop, pair_sweep and fast_recip have no counterpart: the kernels
always compute t with an exact IEEE divide, test each ray against each
cluster box on its own, and end a stage's loop when its ray dies.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

BACKENDS = ("auto", "plain")
RNG_MODES = ("fused", "external")
WAVEFRONTS = ("auto", "mega", "staged")
TRI_ORDERS = ("morton", "file")
INTERSECTS = ("auto", "brute", "bvh")


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera (reference scene.h:3-7 defaults)."""

    eye: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    look: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    height_angle_deg: float = 90.0
    aspect_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 500
    height: int = 500
    spp: int = 100
    # Fixed bounce budget of the Russian-roulette loop.
    max_bounces: int = 16
    p_rr: float = 0.9
    # Probability of sampling a specular path in the inverse pass (reference
    # inv_scene.h:5 P_SPEC = 0).  The inverse kernels (B5, B6) need 0; the
    # plain wavefront path (backend="plain") takes any value.
    p_spec: float = 0.0
    # Geometry epsilons (reference scene_basics.h:13-14).
    min_dot: float = 1e-4
    epsilon: float = 1e-2
    camera: CameraConfig = CameraConfig()
    # Samples per kernel launch.  Every random number is a pure function of
    # the key and the global sample index, so the value changes nothing but
    # launch count and peak memory (~60 bytes per sample).  The JAX
    # package's 16384 was a TPU on-chip-memory size; 16K threads would leave
    # most of an H100's 132 SMs idle.
    tile_size: int = 1 << 20
    # Replicate the reference's estimator quirks Q1/Q2 (render/forward.py).
    reference_quirks: bool = True
    # "auto": the CUDA kernel for CUDA tensors, the plain PyTorch version on
    # the CPU; "plain": the plain PyTorch version on any device (the tests'
    # reference).
    backend: str = "auto"
    # "fused": the in-kernel counter-hash RNG (key words, global sample
    # index); "external": caller-supplied rays and (bounces*8, n) uniforms.
    rng: str = "fused"
    # Bounce-loop organisation (render/forward.py _use_staged): "mega" runs
    # the whole loop per ray in one kernel (B1); "staged" runs stages of
    # stage_bounces bounces (B7, then B8 per stage), re-sorting the lanes
    # between stages so that live rays fill the leading blocks; "auto" is
    # staged exactly on clustered scenes (cluster_k_for > 0).
    wavefront: str = "auto"
    stage_bounces: int = 4
    # Triangles per cluster of the clustered sweep on scenes of at least
    # ops/kernels/clusters.py CLUSTER_MIN_TP padded triangles; 0 = the auto
    # width (cluster_k_for).
    cluster_k: int = 0
    # Kernel-internal triangle order of clustered scenes: "morton" (the
    # largest triangles first, then centroid Z-order) or "file".
    tri_order: str = "morton"
    # Origin cells per axis of the staged wavefront's ray binning on
    # clustered scenes (render/forward.py _binned_order).
    bin_cells: int = 2
    # The closest-hit search of the render and its gradient: "auto" and
    # "brute" sweep every triangle (clustered on large scenes); "bvh", on a
    # scene with a BVH (load_scene(with_bvh=True), ops/bvh.py attach_bvh),
    # traverses the BVH (render_common.cuh traverse on the card,
    # ops/bvh.py intersect_bvh in the plain versions), with the same hits,
    # in one unstaged wavefront whatever `wavefront` says; on a scene
    # without one it sweeps.  The extraction always sweeps, as in the JAX
    # package.
    intersect: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected one of {BACKENDS}")
        if self.rng not in RNG_MODES:
            raise ValueError(f"unknown rng {self.rng!r}; expected one of {RNG_MODES}")
        if self.wavefront not in WAVEFRONTS:
            raise ValueError(f"unknown wavefront {self.wavefront!r}; expected one of {WAVEFRONTS}")
        if self.tri_order not in TRI_ORDERS:
            raise ValueError(f"unknown tri_order {self.tri_order!r}; expected one of {TRI_ORDERS}")
        if self.intersect not in INTERSECTS:
            raise ValueError(f"unknown intersect {self.intersect!r}; expected one of {INTERSECTS}")
        if self.cluster_k < 0 or self.stage_bounces < 1 or self.bin_cells < 1:
            raise ValueError(f"need cluster_k >= 0, stage_bounces >= 1 and bin_cells >= 1, got "
                             f"{self.cluster_k}, {self.stage_bounces}, {self.bin_cells}")

    @property
    def n_samples(self) -> int:
        return self.width * self.height * self.spp

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """GCN / recovery training schedule (reference ipt.py:110-111)."""

    lr: float = 1e-4
    epochs: int = 100_000
    log_every: int = 1000
    hidden: int = 100  # reference ipt.py:33
    p_min: float = 1e-3  # edge threshold, reference ipt.py:26
    seed: int = 0
    checkpoint_every: int = 0  # 0 = disabled
    checkpoint_dir: str = "checkpoints"

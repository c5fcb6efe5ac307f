"""Static render configuration (the fields of the JAX package's
RenderConfig / CameraConfig that the forward path reads).

The TPU tuning fields (wavefront, stage_bounces, cluster_k, pair_sweep,
fast_recip, tri_order) have no counterpart: the CUDA kernel always runs the
whole bounce loop per ray with an exact IEEE divide.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

BACKENDS = ("auto", "plain")
RNG_MODES = ("fused", "external")


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

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected one of {BACKENDS}")
        if self.rng not in RNG_MODES:
            raise ValueError(f"unknown rng {self.rng!r}; expected one of {RNG_MODES}")

    @property
    def n_samples(self) -> int:
        return self.width * self.height * self.spp

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

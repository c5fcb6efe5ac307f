"""Tone mapping (reference toneMap path_trace.cu:186-198): mean over samples,
then Reinhard x/(1+x); uint8 by truncation toward zero; no gamma."""

from __future__ import annotations

import torch


def tonemap_mean(samples: torch.Tensor, spp: int) -> torch.Tensor:
    """(H*W*spp, 3) radiance in sample order (r*W + c)*spp + s ->
    (H*W, 3) float image in [0, 1)."""
    mean = samples.reshape(-1, spp, 3).mean(dim=1)
    return mean / (1.0 + mean)


def tonemap_to_uint8(image01: torch.Tensor) -> torch.Tensor:
    """[0, 1) float image -> uint8 by truncation (the C cast)."""
    return (255.0 * image01).to(torch.uint8)

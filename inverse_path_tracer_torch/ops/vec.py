"""3-vector helpers over (..., 3) tensors with a fixed evaluation order.

Each sum is written out left to right, the same order the CUDA kernel uses
(it is built with -fmad=false), so the plain version and the kernel round
alike on the card.
"""

from __future__ import annotations

import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def normalize3(v: torch.Tensor) -> torch.Tensor:
    """v / |v|, leaving zero vectors unchanged (Eigen's normalize())."""
    n = torch.sqrt(dot3(v, v))
    return v / torch.where(n > 0, n, torch.ones_like(n))[..., None]

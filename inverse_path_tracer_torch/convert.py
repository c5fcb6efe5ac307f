"""Carry a scene and its materials across from numpy arrays.

`scene_from_numpy` takes the leaves of the JAX package's SceneData as numpy
arrays (for example ``{k: np.asarray(v) for k, v in scene._asdict().items()}``)
and returns the port's SceneData, so that both packages render bit-identical
scenes.  Fields the port does not have (the optional BVH) are ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from inverse_path_tracer_torch.scene.build import SceneData

_INDEX_FIELDS = ("emissive_idx", "specular_idx")


def scene_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> SceneData:
    out = {}
    for f in dataclasses.fields(SceneData):
        a = np.asarray(fields[f.name])
        dtype = np.int64 if f.name in _INDEX_FIELDS else np.float32
        out[f.name] = torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    return SceneData(**out)


def materials_from_numpy(materials: np.ndarray, device="cpu") -> torch.Tensor:
    """(nT, 3) Kd array -> float32 tensor on `device`."""
    m = np.array(materials, dtype=np.float32)
    if m.ndim != 2 or m.shape[1] != 3:
        raise ValueError(f"materials must be (nT, 3), got {m.shape}")
    return torch.from_numpy(m).to(device)

"""Carry a scene, its materials and an optimizer state across from numpy
arrays.

`scene_from_numpy` takes the leaves of the JAX package's SceneData as numpy
arrays (for example ``{k: np.asarray(v) for k, v in scene._asdict().items()}``)
and returns the port's SceneData, so that both packages render bit-identical
scenes.  Fields the port does not have (the optional BVH) are ignored.
`adam_state_from_numpy` turns optax.adam's (mu, nu, count) into a
torch.optim.Adam state entry, so both packages can start from one state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

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


def adam_state_from_numpy(mu: np.ndarray, nu: np.ndarray, count: int,
                          device="cpu") -> Dict[str, torch.Tensor]:
    """optax.adam's first and second moments and step count -> the state
    entry torch.optim.Adam keeps for one parameter (``opt.state[param] =
    ...``).  Both optimizers then take the same next step: update = -lr *
    mu_hat / (sqrt(nu_hat) + eps) with the bias corrections of step count+1."""
    as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": as_t(mu), "exp_avg_sq": as_t(nu)}

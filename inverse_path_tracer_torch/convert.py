"""Carry a scene, its materials and an optimizer state across from numpy
arrays.

`scene_from_numpy` takes the leaves of the JAX package's SceneData as numpy
arrays (for example ``{k: np.asarray(v) for k, v in scene._asdict().items()}``,
or `jax_scene_fields(scene)`, which also carries an attached BVH) and returns
the port's SceneData, so that both packages render bit-identical scenes.  The
JAX `bvh` leaf, () or the six arrays of its BVHData, becomes the port's
ops/bvh.py BVHData or None; a missing or empty one means no BVH.
`render_config_from_jax` carries a JAX RenderConfig's fields across.
`adam_state_from_numpy` turns optax.adam's (mu, nu, count) into a
torch.optim.Adam state entry, so both packages can start from one state.
`gcn_params_from_numpy` maps the JAX GCN's parameter dict onto the port's
GCN state_dict, and `read_jax_checkpoint` reads the JAX package's
checkpoint npz (utils/checkpoint.py there) without JAX, so that
``gcn_params_from_numpy(read_jax_checkpoint("artifacts/exp100/gcn0_params.npz")[0])``
loads the trained GCN.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from inverse_path_tracer_torch.config import CameraConfig, RenderConfig
from inverse_path_tracer_torch.scene.build import SceneData

_INDEX_FIELDS = ("emissive_idx", "specular_idx")
# RenderConfig fields whose JAX values mean something else in the port:
# backend ("xla", "pallas"), rng ("auto") and tile_size (a TPU memory size).
_CONFIG_OWN = ("backend", "rng", "tile_size")


def render_config_from_jax(cfg) -> RenderConfig:
    """The port's RenderConfig of a JAX RenderConfig (any object with its
    attributes): every field of the port's config but backend, rng and
    tile_size, which keep the port's defaults; the camera field by field."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(RenderConfig)
          if f.name not in _CONFIG_OWN and f.name != "camera" and hasattr(cfg, f.name)}
    cam = cfg.camera
    kw["camera"] = CameraConfig(**{f.name: tuple(getattr(cam, f.name))
                                   if isinstance(getattr(cam, f.name), (tuple, list))
                                   else getattr(cam, f.name)
                                   for f in dataclasses.fields(CameraConfig)})
    return RenderConfig(**kw)


def jax_scene_fields(scene) -> Dict[str, object]:
    """The leaves of a JAX SceneData as numpy arrays, its `bvh` leaf as a
    tuple of numpy arrays (a tuple of arrays of several shapes is no array)."""
    return {k: tuple(np.asarray(a) for a in v) if k == "bvh" else np.asarray(v)
            for k, v in scene._asdict().items()}


def scene_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> SceneData:
    """The port's scene of a JAX scene's numpy fields; its BVH, if any, is
    checked by ops/bvh.py check_bvh (the traversal's preconditions)."""
    from inverse_path_tracer_torch.ops.bvh import BVHData, check_bvh

    out = {}
    for f in dataclasses.fields(SceneData):
        if f.name == "bvh":
            leaf = fields.get("bvh")
            bvh = BVHData.from_numpy(leaf) if leaf is not None and len(leaf) > 0 else None
            if bvh is not None:
                check_bvh(bvh, np.asarray(fields["vertices"]).shape[0])
            out["bvh"] = None if bvh is None else bvh.to(device)
            continue
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


def gcn_params_from_numpy(params: Mapping[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX GCN's {lift_w (3, 100), lift_b, mpl{i}_w (200, 100), mpl{i}_b,
    out_w (100, 3), out_b} -> a state_dict of models.gcn.GCN: each weight
    (fan_in, fan_out) becomes nn.Linear's (out, in)."""
    names = {"lift": "lift", "out": "out"}
    names.update({f"mpl{i}": f"mpl.{i}" for i in range(len(params))})
    out = {}
    for key, a in params.items():
        layer, kind = key.rsplit("_", 1)
        a = np.array(a, dtype=np.float32)
        t = torch.from_numpy(a.T.copy() if kind == "w" else a).to(device)
        out[f"{names[layer]}.{'weight' if kind == 'w' else 'bias'}"] = t
    return out


def read_jax_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """({name: array}, step) of a checkpoint of a flat dict written by the
    JAX package's save_checkpoint: leaf_i follows the key order of the
    treedef string in __meta__ (jax flattens dicts by sorted key)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        keys = re.findall(r"'([^']+)': \*", meta["treedef"])
        if len(keys) != sum(1 for k in data.files if k.startswith("leaf_")):
            raise ValueError(f"{path}: treedef {meta['treedef']!r} is not a flat dict")
        arrays = {k: np.array(data[f"leaf_{i}"]) for i, k in enumerate(keys)}
    return arrays, int(meta.get("step", 0))

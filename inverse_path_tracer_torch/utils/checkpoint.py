"""Checkpoint / resume (the counterpart of the JAX package's
utils/checkpoint.py).

A checkpoint is an npz of named arrays plus a ``__meta__`` entry, a JSON
object with the step (and any other metadata), written to a temporary file
and moved into place with os.replace, so that a reader never sees a half
written file.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def save_checkpoint(path: str, arrays: Mapping[str, torch.Tensor], step: int = 0, **meta) -> None:
    """Write the named tensors (or arrays) and the step to `path` atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    out = {}
    for name, a in arrays.items():
        if name == "__meta__":
            raise ValueError("'__meta__' is reserved")
        out[name] = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    out["__meta__"] = np.frombuffer(
        json.dumps({"step": step, "names": sorted(arrays), **meta}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, path)  # atomic


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """(named CPU tensors, step) of a checkpoint written by save_checkpoint."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {name: torch.from_numpy(np.array(data[name])) for name in meta["names"]}
    return arrays, int(meta.get("step", 0))

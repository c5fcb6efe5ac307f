"""What the experiment modules share: the repository's paths, the device
line of a metrics block, logging to stderr, atomic JSON writes and phase
clocks."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import List

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The in-repo 100 scene files, generate_scene_files(100, seed=0): one
# geometry, the cube's Kd differs.
SCENES_DIR = os.path.join(REPO, "scenes")
EXP100 = os.path.join(REPO, "artifacts", "exp100")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def device_names(dev: torch.device) -> List[str]:
    """The metrics block's `devices`: "cpu", or per card its name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` prints them."""
    if dev.type != "cuda":
        return [str(dev)]
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        lines = [line.strip() for line in out.splitlines() if line.strip()]
    except (OSError, subprocess.SubprocessError):
        lines = []
    return lines or [f"{torch.cuda.get_device_name(dev)}, power limit not read"]


def write_json(path: str, obj) -> None:
    """Write `obj` as JSON atomically (a cut run leaves the last whole file)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def seconds_since(t0: float, dev: torch.device) -> float:
    """Wall seconds since t0, after the device has finished its work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return round(time.time() - t0, 2)

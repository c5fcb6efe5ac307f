"""Scene description DSL (reference ipt_cuda.py:39-107).

Format::

    OBJECT
    POS x y z
    ORI x y z          # axis-angle: axis = ORI/|ORI|, angle = |ORI| (rad)
    SCL x y z
    OBJ path/to.obj
    MTL path/to.mtl    # or inline: *Kd r g b*

Defaults when omitted: POS 0 0 0, ORI 0 0 0, SCL 1 1 1.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class ObjectParams:
    """One object instance (reference ObjParams_t scene_basics.h:112-137)."""

    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ori: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scl: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    obj_file: str = ""
    mtl_file: str = ""


def object_from_string(string: str) -> ObjectParams:
    """Parse one object block."""
    pos = ori = scl = obj_file = mtl_file = None
    for line in string.split("\n"):
        items = line.strip().split(" ")
        token, values = items[0], items[1:]
        if token == "POS":
            pos = tuple(float(x) for x in values)
        elif token == "ORI":
            ori = tuple(float(x) for x in values)
        elif token == "SCL":
            scl = tuple(float(x) for x in values)
        elif token == "OBJ":
            obj_file = values[0]
        elif token == "MTL":
            # Inline materials contain spaces.
            mtl_file = " ".join(values)
    if obj_file is None or mtl_file is None:
        raise ValueError(f"object block needs OBJ and MTL lines: {string!r}")
    return ObjectParams(
        pos=pos or (0.0, 0.0, 0.0),
        ori=ori or (0.0, 0.0, 0.0),
        scl=scl or (1.0, 1.0, 1.0),
        obj_file=obj_file,
        mtl_file=mtl_file,
    )


def load_params(filename: str) -> List[ObjectParams]:
    """Parse a scene file into object params."""
    with open(filename, "r") as f:
        lines = f.readlines()
    params: List[ObjectParams] = []
    curr = ""
    for line in lines:
        line = line.strip()
        if line == "OBJECT":
            if curr:
                params.append(object_from_string(curr))
            curr = ""
        else:
            curr += line + "\n"
    params.append(object_from_string(curr))
    return params


def standard_scene_string(rng: np.random.Generator) -> str:
    """The dataset generator's scene (reference ipt_cuda.py:115-128): the
    Cornell box at POS (0,0,4) SCL 2 and a unit cube at POS (0,-1.5,4) whose
    inline Kd draws three independent uniforms, in the JAX package's text."""
    kd = f"*Kd {rng.uniform()} {rng.uniform()} {rng.uniform()}*"
    return ("OBJECT\nPOS 0 0 4\nSCL 2.0 2.0 2.0\nOBJ ./CornellBox/CornellBox-Empty-CO.obj\n"
            "MTL ./CornellBox/CornellBox-Empty-CO.mtl\n"
            f"OBJECT\nPOS 0.0 -1.5 4.0\nOBJ ./shapes/cube.obj\nMTL {kd}\n")


def generate_scene_files(n: int, out_dir: str = "scenes", seed: int = 0) -> List[str]:
    """Write n scene files {out_dir}/{i}.txt from one seeded generator (the
    reference's generator is unseeded)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = os.path.join(out_dir, f"{i}.txt")
        with open(path, "w") as f:
            f.write(standard_scene_string(rng))
        paths.append(path)
    return paths

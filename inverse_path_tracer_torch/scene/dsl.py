"""Scene description DSL (reference ipt_cuda.py:14-128): the writers and
the parser of the scene text, character for character the JAX package's.

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
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Shape enum (reference ipt_cuda.py:9).
CUBE, SPHERE, CORNELL, OTHER = 0, 1, 2, 3

SHAPE_OBJ_FILES = {
    CUBE: "./shapes/cube.obj",
    SPHERE: "./shapes/sphere.obj",
    CORNELL: "./CornellBox/CornellBox-Empty-CO.obj",
}
CORNELL_MTL_FILE = "./CornellBox/CornellBox-Empty-CO.mtl"


@dataclasses.dataclass
class ObjectParams:
    """One object instance (reference ObjParams_t scene_basics.h:112-137)."""

    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ori: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scl: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    obj_file: str = ""
    mtl_file: str = ""


def rand_mtl(rng: Optional[np.random.Generator] = None) -> str:
    """A random inline diffuse of three independent uniforms (reference
    ipt_cuda.py:14-15)."""
    rng = rng or np.random.default_rng()
    return f"*Kd {rng.uniform()} {rng.uniform()} {rng.uniform()}*"


def object_to_string(
    shp: Optional[int] = None,
    pos: Optional[Sequence[float]] = None,
    ori: Optional[Sequence[float]] = None,
    scl: Optional[Sequence[float]] = None,
    obj_file: Optional[str] = None,
    mtl_file: Optional[str] = None,
    rng: Optional[np.random.Generator] = None,
) -> str:
    """One object block (reference ipt_cuda.py:17-37).  A CUBE or SPHERE
    takes its shape's OBJ and, without mtl_file, rand_mtl(rng); CORNELL
    takes the box's OBJ and MTL; otherwise obj_file and mtl_file are
    required."""
    s = ""
    if pos is not None:
        s += f"POS {pos[0]} {pos[1]} {pos[2]}\n"
    if ori is not None:
        s += f"ORI {ori[0]} {ori[1]} {ori[2]}\n"
    if scl is not None:
        s += f"SCL {scl[0]} {scl[1]} {scl[2]}\n"
    if shp in (CUBE, SPHERE):
        obj_file = SHAPE_OBJ_FILES[shp]
        mtl_file = rand_mtl(rng) if mtl_file is None else mtl_file
    elif shp == CORNELL:
        obj_file = SHAPE_OBJ_FILES[CORNELL]
        mtl_file = CORNELL_MTL_FILE
    if obj_file is None or mtl_file is None:
        raise ValueError("an object block needs an OBJ and an MTL")
    return s + f"OBJ {obj_file}\nMTL {mtl_file}\n"


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


def standard_scene_string(rng: Optional[np.random.Generator] = None,
                          mtl_file: Optional[str] = None) -> str:
    """The dataset generator's scene (reference ipt_cuda.py:115-128): the
    Cornell box at POS (0,0,4) SCL 2 and a unit cube at POS (0,-1.5,4) with
    the material mtl_file, or else rand_mtl(rng)."""
    return ("OBJECT\n" + object_to_string(shp=CORNELL, pos=(0, 0, 4), scl=(2.0, 2.0, 2.0))
            + "OBJECT\n"
            + object_to_string(shp=CUBE, pos=(0.0, -1.5, 4.0), mtl_file=mtl_file, rng=rng))


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

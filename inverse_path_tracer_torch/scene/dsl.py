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
from typing import List, Tuple


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

"""What the harness hands the program: its scene, built by the program's
own loader from the configuration's asset files, the render settings, the
materials drawn from the seed, and the job keys.  Nothing here computes a
result; the program's modules are imported when a run needs them."""

from __future__ import annotations

import os
import random
from typing import List

import torch

from benchmark.reference import rng as rr
from benchmark.reference import scene as rscene

BASE_TAG = 0x42454E43  # fold_in data of a run's base key ("BENC")


def asset_root() -> str:
    from inverse_path_tracer_torch.scene.build import ASSET_ROOT

    return ASSET_ROOT


def build_scene(config: dict, gen_dir: str):
    """The program's SceneData (on the CPU) of the configuration's
    objects: asset OBJ/MTL files, or the generated sphere's OBJ file."""
    from inverse_path_tracer_torch.scene.build import build_scene as program_build
    from inverse_path_tracer_torch.scene.dsl import ObjectParams

    root = asset_root()
    objects = []
    for o in config["objects"]:
        kd = o.get("kd", (0.5, 0.5, 0.5))
        mtl = os.path.join(root, o["mtl"]) if "mtl" in o else "*Kd %r %r %r*" % tuple(kd)
        objects.append(ObjectParams(pos=tuple(o["pos"]), scl=tuple(o.get("scl", (1, 1, 1))),
                                    obj_file=rscene.object_file(o, root, gen_dir), mtl_file=mtl))
    return program_build(objects, asset_root=root)


def reference_scene(config: dict, gen_dir: str):
    return rscene.build(config["objects"], asset_root(), gen_dir)


def render_config(config: dict, traffic: dict):
    from inverse_path_tracer_torch.config import RenderConfig

    r = config["renderer"]
    return RenderConfig(width=traffic["width"], height=traffic["height"], spp=traffic["spp"],
                        max_bounces=r["max_bounces"], p_rr=r["p_rr"],
                        reference_quirks=r["reference_quirks"], rng=r["rng"])


def seeded_rows(config: dict, gen_dir: str) -> List[range]:
    """Triangle rows of the objects whose Kd is drawn from the seed."""
    rows, at = [], 0
    for o in config["objects"]:
        n = rscene.read_obj(rscene.object_file(o, asset_root(), gen_dir))[2].shape[0]
        if o.get("kd_from_seed"):
            rows.append(range(at, at + n))
        at += n
    return rows


def materials(base: torch.Tensor, config: dict, gen_dir: str, gen: torch.Generator,
              count: int) -> torch.Tensor:
    """(count, nT, 3) copies of the scene's Kd, each seeded object's rows
    set to one Kd of three uniforms (the upstream generator's rand_mtl)."""
    out = base.to(gen.device).repeat(count, 1, 1)
    for rows in seeded_rows(config, gen_dir):
        kd = torch.rand((count, 1, 3), generator=gen, device=gen.device)
        out[:, rows.start:rows.stop] = kd.expand(count, len(rows), 3)
    return out


def base_key(seed: int) -> int:
    return rr.fold_in(seed % (1 << 64), BASE_TAG)


class Reservoir:
    """A uniform sample of k of the jobs, drawn from the seed as jobs come."""

    def __init__(self, k: int, seed: int):
        self.k, self.rand, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, make):
        """Keep make()'s item with the reservoir's probability."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rand.randrange(self.seen)
            if j < self.k:
                self.items[j] = make()

"""The label-free observability gate and the hybrid Kd estimator (the
counterpart of the JAX package's scripts/gate_recover100.py).

Pixel-loss refinement recovers the Kd of faces the camera sees and
random-walks the rest at the Monte-Carlo noise floor; the transport-graph
GCN constrains every face a path touches but is less sharp on the visible
ones.  The gate picks, per triangle and without labels,

  gate(t) = (emission[t] == 0) AND (direct_px[t] >= W*H / 4096)

where direct_px[t] counts the pixels whose first camera-ray hit is t: one
jittered primary ray per pixel at the recovery resolution under the fixed
key 7 (geometry and camera only).  The hybrid takes the refined Kd on gated
triangles and the GCN's elsewhere.  Labels are read only by gated_report.

On the card the first hits come from B10 alone (ops/kernels/render_kernel.py
intersect_tile), on the CPU from its plain version.

Run on a recover100 work directory (recover100 also runs it at its end):

    python -m inverse_path_tracer_torch.experiments.gate --workdir runs/recover100

reads   <workdir>/recovered.npy, gcn_init.npy and metrics.json["recover100"]
writes  <workdir>/recovered_gated.npy and the gate's keys into that block.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.experiments.common import SCENES_DIR, log, write_json
from inverse_path_tracer_torch.ops.camera import camera_rays
from inverse_path_tracer_torch.ops.kernels.clusters import kernel_perm
from inverse_path_tracer_torch.ops.kernels.render_kernel import intersect_tile
from inverse_path_tracer_torch.render.forward import resolve_device
from inverse_path_tracer_torch.scene.build import ASSET_ROOT, SceneData, load_scene

GATE_KEY = 7
# The cube's triangles (the learnable unknowns; the Cornell box's Kd is
# shared by the 100 scenes).
CUBE = slice(18, None)
RULE = ("non-emissive AND direct_px >= W*H/4096 (label-free; see "
        "inverse_path_tracer_torch/experiments/gate.py)")


def gate_config(res: int) -> RenderConfig:
    return RenderConfig(width=res, height=res, spp=1, max_bounces=1)


def gate_rays(scene: SceneData, res: int, key: int = GATE_KEY
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One jittered primary ray per pixel at res x res under `key`, as the
    kernels take rays: p, d (3, res*res) on the scene's device."""
    idx = torch.arange(res * res, dtype=torch.int64, device=scene.device)
    p, d = camera_rays(scene, gate_config(res), key, idx)
    return p.T.contiguous(), d.T.contiguous()


def direct_pixel_counts(scene: SceneData, res: int, key: int = GATE_KEY, device=None,
                        rays: Optional[Tuple[object, object]] = None) -> np.ndarray:
    """(nT,) int64: the pixels whose first camera-ray hit is each triangle,
    one ray per pixel at res x res (gate_rays under `key`, or the caller's
    rays=(p, d), each (3, res*res)).  A miss counts nowhere; the kernels'
    internal triangle rows are mapped back to global ones."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    cfg = gate_config(res)
    if rays is None:
        p, d = gate_rays(scene, res, key)
    else:
        p, d = (torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(dev) for a in rays)
    t, row = intersect_tile(scene, cfg, p, d)
    perm = kernel_perm(scene, cfg)
    tri = row.long() if perm is None else perm[row.long()]
    hit = torch.isfinite(t)
    return torch.bincount(tri[hit], minlength=scene.n_tri).cpu().numpy()


def compute_gate(scene: SceneData, res: int, device=None
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(gate (nT,) bool, direct_px (nT,), threshold): label-free."""
    direct_px = direct_pixel_counts(scene, res, device=device)
    threshold = max(1, (res * res) // 4096)
    emissive = scene.emission.max(dim=1).values.cpu().numpy() > 0
    return (~emissive) & (direct_px >= threshold), direct_px, threshold


def assemble_hybrid(gate: np.ndarray, refined: np.ndarray, gcn: np.ndarray) -> np.ndarray:
    """The hybrid estimator (S, nT, 3): refined Kd on gated triangles, the
    GCN's elsewhere."""
    return np.where(np.asarray(gate)[None, :, None], refined, gcn)


def per_face_cube_err(err: np.ndarray) -> list:
    """Mean |error| per cube triangle over scenes and channels, (S, nT, 3)
    -> 12 numbers rounded to 4 places (the JAX scripts' lists)."""
    return [round(float(v), 4) for v in err[:, CUBE, :].mean(axis=(0, 2))]


def gated_report(metrics: dict, gate: np.ndarray, direct_px: np.ndarray, threshold: int,
                 refined: np.ndarray, gcn: np.ndarray, labels: np.ndarray) -> dict:
    """Write the gate and the errors of the hybrid, of the refined and of the
    GCN's Kd against the labels into `metrics` (the JAX script's keys), and
    return it.  The only place labels are read."""
    err = np.abs(assemble_hybrid(gate, refined, gcn) - labels)
    metrics["per_face_cube_err"] = per_face_cube_err(np.abs(refined - labels))
    metrics["gcn_init_per_face_cube_err"] = per_face_cube_err(np.abs(gcn - labels))
    metrics["observability"] = {"direct_px": [int(c) for c in direct_px],
                                "threshold_px": int(threshold), "rule": RULE}
    metrics["observability_gate_tris"] = [int(t) for t in np.nonzero(gate)[0]]
    metrics["gated_mean_kd_err"] = float(err.mean())
    metrics["gated_mean_kd_err_cube"] = float(err[:, CUBE, :].mean())
    metrics["gated_per_face_cube_err"] = per_face_cube_err(err)
    return metrics


def scene_labels(n: int, scenes_dir: str, asset_root: str) -> np.ndarray:
    """(n, nT, 3) Kd of scenes_dir/0..n-1.txt."""
    return np.stack([load_scene(os.path.join(scenes_dir, f"{i}.txt"),
                                asset_root=asset_root).diffuse.numpy() for i in range(n)])


def gate_run(workdir: str, metrics: dict, scene: SceneData, refined: np.ndarray,
             gcn: np.ndarray, labels: np.ndarray, device) -> dict:
    """The gate at the run's resolution, the hybrid saved as
    <workdir>/recovered_gated.npy, and gated_report into `metrics`."""
    gate, direct_px, threshold = compute_gate(scene, int(metrics["config"]["res"]), device)
    log(f"gate ({int(gate.sum())}/{scene.n_tri} tris, direct_px >= {threshold}, "
        f"non-emissive): {np.nonzero(gate)[0].tolist()}")
    np.save(os.path.join(workdir, "recovered_gated.npy"), assemble_hybrid(gate, refined, gcn))
    return gated_report(metrics, gate, direct_px, threshold, refined, gcn, labels)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="inverse_path_tracer_torch.experiments.gate")
    ap.add_argument("--workdir", default=os.path.join("runs", "recover100"),
                    help="a recover100 work directory")
    ap.add_argument("--scenes-dir", default=SCENES_DIR)
    ap.add_argument("--asset-root", default=ASSET_ROOT)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    mpath = os.path.join(args.workdir, "metrics.json")
    with open(mpath) as f:
        all_m = json.load(f)
    if "recover100" not in all_m:
        raise SystemExit(f"no 'recover100' block in {mpath}; run recover100 first")
    metrics = all_m["recover100"]
    refined = np.load(os.path.join(args.workdir, "recovered.npy"))
    gcn = np.load(os.path.join(args.workdir, "gcn_init.npy"))
    scene = load_scene(os.path.join(args.scenes_dir, "0.txt"), asset_root=args.asset_root)
    labels = scene_labels(refined.shape[0], args.scenes_dir, args.asset_root)
    gate_run(args.workdir, metrics, scene, refined, gcn, labels, dev)
    write_json(mpath, all_m)
    print(json.dumps({k: metrics[k] for k in ("observability_gate_tris", "gated_mean_kd_err",
                                              "gated_mean_kd_err_cube",
                                              "gated_per_face_cube_err")}), flush=True)
    return metrics


if __name__ == "__main__":
    main()

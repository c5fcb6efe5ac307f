"""Batched recovery of 100 scenes of one geometry, warm-started from the GCN,
then the label-free gate and the hybrid estimator (the counterpart of the
JAX package's scripts/run_recover100.py, BASELINE.json config #5, followed
by scripts/gate_recover100.py).

Phases, each timed into <workdir>/metrics.json["recover100"] (the JAX
block's keys):

  1. targets: scene i rendered at res^2/target-spp under rng.fold_in(100, i)
     to <workdir>/i.png (skipped where the PNG exists);
  2. with --init gcn, the GCN's predictions: scene i rendered at
     GRAPH_RES^2/GRAPH_SPP under rng.fold_in(100, 50_000 + i), its graph
     extracted under rng.fold_in(500, i), the GCN of --gcn run on it; cached
     as <workdir>/gcn_init.npy;
  3. batched recovery from those predictions (recover_materials_batched):
     a checkpoint every CHECKPOINT_EVERY steps, resumed when present (a
     resumed run ends bit-identical to an uninterrupted one, losses.jsonl
     included: the lines of the steps past the checkpoint are dropped before
     they are taken again), the loss of every step appended to
     <workdir>/losses.jsonl; <workdir>/recovered.npy;
  4. re-renders of scenes 0, 50 and 99 with the recovered and the true Kd;
  5. with --init gcn, the gate and the hybrid (experiments/gate.py):
     <workdir>/recovered_gated.npy and the gated errors.

Run (the JAX package's 256^2 configuration):

    python -m inverse_path_tracer_torch.experiments.recover100 --steps 100 \\
        --lr 1e-2 --avg 40 --init gcn --workdir runs/recover100_256

The default --gcn is the checkpoint the JAX run used,
artifacts/exp100/gcn_params.npz.  Keys are integer seeds of ops/rng.py, so
the two packages draw different samples of one estimator.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.data.pipeline import load_image01
from inverse_path_tracer_torch.experiments.common import (
    EXP100,
    SCENES_DIR,
    device_names,
    log,
    seconds_since,
    write_json,
)
from inverse_path_tracer_torch.experiments.gate import CUBE, gate_run, per_face_cube_err
from inverse_path_tracer_torch.models.gcn import build_dense_graph, load_gcn
from inverse_path_tracer_torch.models.recover import recover_materials_batched
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.render.forward import render_to_png, resolve_device
from inverse_path_tracer_torch.render.inverse import extract_graph
from inverse_path_tracer_torch.scene.build import ASSET_ROOT, load_scene
from inverse_path_tracer_torch.utils.checkpoint import load_checkpoint

TARGET_KEY = 100
GRAPH_KEY = 500
RERENDER = (0, 50, 99)
# As the JAX script fixes them: 16 bounces, the GCN's graphs at its training
# statistics (500x500/100 spp), a checkpoint every 25 recovery steps.
BOUNCES = 16
GRAPH_RES = 500
GRAPH_SPP = 100
CHECKPOINT_EVERY = 25


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="inverse_path_tracer_torch.experiments.recover100")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--target-spp", type=int, default=None, help="default: --spp")
    ap.add_argument("--keys", type=int, default=1, help="gradient keys averaged per step")
    ap.add_argument("--avg", type=int, default=0, help="Polyak average of the last AVG steps")
    ap.add_argument("--scenes", type=int, default=100)
    ap.add_argument("--scene-chunk", type=int, default=0,
                    help="scenes rendered and backpropagated together (0 = all)")
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--init", default="none", choices=("none", "gcn"))
    ap.add_argument("--gcn", default=os.path.join(EXP100, "gcn_params.npz"),
                    help="GCN checkpoint (this package's or the JAX package's)")
    ap.add_argument("--workdir", default=os.path.join("runs", "recover100"))
    ap.add_argument("--scenes-dir", default=SCENES_DIR)
    ap.add_argument("--asset-root", default=ASSET_ROOT)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def gcn_predictions(args, scenes, cfg: RenderConfig, dev) -> np.ndarray:
    """(S, nT, 3) GCN predictions on each scene's graph (phase 2)."""
    model = load_gcn(args.gcn, dev)
    g_cfg = cfg.with_(width=GRAPH_RES, height=GRAPH_RES, spp=GRAPH_SPP)
    gdir = os.path.join(args.workdir, f"graph{GRAPH_RES}")
    os.makedirs(gdir, exist_ok=True)
    t0 = time.time()
    preds = []
    for i, scene in enumerate(scenes):
        gp = os.path.join(gdir, f"{i}.png")
        if not os.path.exists(gp):
            render_to_png(scene.diffuse, scene, rng.fold_in(TARGET_KEY, 50_000 + i), g_cfg, gp,
                          device=dev)
        w, pixel, _ = extract_graph(scene, load_image01(gp), rng.fold_in(GRAPH_KEY, i), g_cfg,
                                    device=dev)
        with torch.no_grad():
            preds.append(model(*build_dense_graph(w, pixel)).cpu())
        if i % 20 == 0:
            log(f"graph+gcn {i} done ({time.time() - t0:.0f}s)")
    return torch.stack(preds).numpy()


def kept_losses(path: str, start: int) -> list:
    """The lines of losses.jsonl of the steps before `start`, the step a
    resumed recovery starts from: it takes the later ones again."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line for line in f if line.endswith("\n") and json.loads(line)["step"] < start]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    n, work = args.scenes, args.workdir
    target_spp = args.spp if args.target_spp is None else args.target_spp
    cfg = RenderConfig(width=args.res, height=args.res, spp=args.spp, max_bounces=BOUNCES)
    os.makedirs(work, exist_ok=True)
    devices = device_names(dev)
    log(f"devices: {devices}; {n} scenes at {args.res}x{args.res}/{args.spp}spp "
        f"(targets {target_spp}spp, {args.keys} grad keys/step), {args.steps} steps -> {work}")
    metrics = {"config": {"n": n, "res": args.res, "spp": args.spp, "target_spp": target_spp,
                          "n_keys": args.keys, "avg_last": args.avg, "lr": args.lr,
                          "steps": args.steps, "scene_chunk": args.scene_chunk,
                          "devices": devices}}

    # --- Phase 1: targets ---
    t0 = time.time()
    scenes = [load_scene(os.path.join(args.scenes_dir, f"{i}.txt"), asset_root=args.asset_root)
              for i in range(n)]
    target_cfg = cfg.with_(spp=target_spp)
    for i, scene in enumerate(scenes):
        path = os.path.join(work, f"{i}.png")
        if not os.path.exists(path):
            render_to_png(scene.diffuse, scene, rng.fold_in(TARGET_KEY, i), target_cfg, path,
                          device=dev)
    metrics["targets_wall_s"] = seconds_since(t0, dev)
    log(f"targets: {metrics['targets_wall_s']}s")
    targets = torch.stack([load_image01(os.path.join(work, f"{i}.png")) for i in range(n)])
    labels = np.stack([s.diffuse.numpy() for s in scenes])

    # --- Phase 2: the GCN's predictions ---
    init = None
    if args.init == "gcn":
        t0 = time.time()
        init_npy = os.path.join(work, "gcn_init.npy")
        if os.path.exists(init_npy):
            init = np.load(init_npy)
            log("gcn init loaded from cache")
        else:
            init = gcn_predictions(args, scenes, cfg, dev)
            np.save(init_npy, init)
        metrics["gcn_graphs_wall_s"] = seconds_since(t0, dev)
        ie = np.abs(init - labels)
        metrics["gcn_init_err"] = float(ie.mean())
        metrics["gcn_init_err_cube"] = float(ie[:, CUBE, :].mean())
        metrics["gcn_init_per_face_cube_err"] = per_face_cube_err(ie)
        metrics["config"]["init"] = "gcn"
        log(f"gcn init: mean |err| vs labels {metrics['gcn_init_err']:.4f}")

    # --- Phase 3: batched recovery ---
    t0 = time.time()
    ckpt = os.path.join(work, "ckpt.npz")
    losses_path = os.path.join(work, "losses.jsonl")
    kept = kept_losses(losses_path, load_checkpoint(ckpt)[1] if os.path.exists(ckpt) else 0)
    with open(losses_path, "w") as lf:
        lf.writelines(kept)

        def log_fn(s, loss):
            if s % 10 == 0:
                log(f"step {s}: loss {loss:.6f} ({time.time() - t0:.0f}s)")
            lf.write(json.dumps({"step": s, "loss": loss}) + "\n")
            lf.flush()

        mats, losses = recover_materials_batched(
            scenes[0], targets, cfg, steps=args.steps, lr=args.lr, key=0, log_fn=log_fn,
            checkpoint_path=ckpt, checkpoint_every=CHECKPOINT_EVERY, resume=True, n_keys=args.keys,
            average_last=args.avg, init_materials=init, scene_chunk=args.scene_chunk,
            device=dev)
    metrics["recover_wall_s"] = seconds_since(t0, dev)
    refined = mats.cpu().numpy()
    np.save(os.path.join(work, "recovered.npy"), refined)
    err = np.abs(refined - labels)
    metrics["mean_kd_err"] = float(err.mean())
    metrics["mean_kd_err_cube"] = float(err[:, CUBE, :].mean())
    metrics["per_face_cube_err"] = per_face_cube_err(err)
    metrics["max_scene_err"] = float(err.mean(axis=(1, 2)).max())
    metrics["final_loss"] = losses[-1] if losses else None
    log(f"recover: {metrics['recover_wall_s']}s, mean |Kd err| {metrics['mean_kd_err']:.4f} "
        f"(cube {metrics['mean_kd_err_cube']:.4f})")

    # --- Phase 4: sample re-renders ---
    t0 = time.time()
    for i in (i for i in RERENDER if i < n):
        key = rng.fold_in(TARGET_KEY, 10_000 + i)
        render_to_png(torch.from_numpy(refined[i]), scenes[i], key, cfg,
                      os.path.join(work, f"{i}_pred.png"), device=dev)
        render_to_png(scenes[i].diffuse, scenes[i], key, cfg,
                      os.path.join(work, f"{i}_true.png"), device=dev)
    metrics["rerender_wall_s"] = seconds_since(t0, dev)

    # --- Phase 5: the gate and the hybrid ---
    if init is not None:
        gate_run(work, metrics, scenes[0], refined, init, labels, dev)
        log(f"gated: mean |Kd err| {metrics['gated_mean_kd_err']:.4f} (cube "
            f"{metrics['gated_mean_kd_err_cube']:.4f})")

    mpath = os.path.join(work, "metrics.json")
    all_m = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            all_m = json.load(f)
    all_m["recover100"] = metrics
    write_json(mpath, all_m)
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()

"""The reference experiment end to end at full scale (the counterpart of the
JAX package's scripts/full_pipeline.py; reference ipt.py main and
ipt_cuda.py generate_files/generate_data), at the reference's native
workload, 100 scenes at 500x500/100 spp:

  generate  n random-Kd scene files and their renders (ipt_cuda.py:115-134);
            the first 100 are the in-repo scenes/ (generate_scene_files(100,
            seed=0))
  dataset   transport-graph extraction of every scene -> data.npz
            (ipt_cuda.generate_data, ipt.py:90-98)
  train     the GCN on all n graphs -> gcn_params.npz
  train0    the reference's own experiment: the GCN on scene 0 alone
            (ipt.py:100), then scene 0 re-rendered with its Kd -> preds0/
  evaluate  preds/i_true.png against preds/i_pred.png, PSNR (ipt.py:127-140)
  recover   batched gradient recovery of the first --recover-n scenes from
            their renders box-downsampled to the recovery resolution

Run:

    python -m inverse_path_tracer_torch.experiments.full_pipeline \\
        --workdir runs/demo100 [--n 100] [--phases generate,dataset,...]

Writes <workdir>/metrics.json, one block per phase under the JAX script's
names, with its wall seconds and quality figures.  The two GCN trainings
checkpoint every 10,000 epochs and resume from the checkpoint, so that a cut
run started again with --phases train,train0,evaluate,recover ends as an
uninterrupted one.  Images are read and written by utils/png.py.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Optional, Sequence

import numpy as np
import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.data.pipeline import (
    generate_data,
    generate_files,
    load_image01,
    render_with_materials,
)
from inverse_path_tracer_torch.experiments.common import (
    device_names,
    log,
    seconds_since,
    write_json,
)
from inverse_path_tracer_torch.models.gcn import build_dense_graph, load_gcn, train_gcn
from inverse_path_tracer_torch.models.recover import recover_materials_batched
from inverse_path_tracer_torch.render.forward import resolve_device
from inverse_path_tracer_torch.scene.build import ASSET_ROOT, load_scene
from inverse_path_tracer_torch.utils.checkpoint import save_checkpoint
from inverse_path_tracer_torch.utils.metrics import psnr
from inverse_path_tracer_torch.utils.png import read_png

PHASES = ("generate", "dataset", "train", "train0", "evaluate", "recover")
GCN_LR = 1e-4
GCN_LOG_EVERY = 10_000
RECOVER_LR = 5e-2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="inverse_path_tracer_torch.experiments.full_pipeline")
    ap.add_argument("--workdir", default=os.path.join("runs", "demo100"))
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--width", type=int, default=500)
    ap.add_argument("--height", type=int, default=500)
    ap.add_argument("--spp", type=int, default=100)
    ap.add_argument("--bounces", type=int, default=16)
    ap.add_argument("--gcn-epochs", type=int, default=100_000)
    ap.add_argument("--recover-n", type=int, default=16)
    ap.add_argument("--recover-steps", type=int, default=200)
    ap.add_argument("--recover-res", type=int, default=256)
    ap.add_argument("--recover-spp", type=int, default=64)
    ap.add_argument("--eval-scenes", type=int, default=4)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--asset-root", default=ASSET_ROOT)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def psnr_files(true_png: str, pred_png: str) -> float:
    a = read_png(true_png).astype(np.float32) / 255
    b = read_png(pred_png).astype(np.float32) / 255
    return float(psnr(a, b))


def load_graphs(data_npz: str, idx, dev):
    """(adjacency, node features, labels) of scenes `idx` of data.npz, each
    stacked over the scenes."""
    with np.load(data_npz) as d:
        w, pixel, labels = (torch.from_numpy(np.array(d[k][idx])).to(dev)
                            for k in ("w", "pixel", "labels"))
    return (*build_dense_graph(w, pixel), labels)


def recover(work: str, n: int, rcfg: RenderConfig, steps: int, asset_root: str, dev,
            key: int = 0):
    """The recover phase: batched recovery of scenes 0..n-1 of `work` from
    Kd 0.5, their stored renders box-downsampled to rcfg's resolution.
    Returns (recovered Kd, true Kd), each (n, nT, 3), and the losses."""
    scene_file = lambda i: os.path.join(work, "scenes", f"{i}.txt")
    res = (rcfg.width, rcfg.height)
    targets = torch.stack([load_image01(os.path.join(work, "imgs", f"{i}.png"), res)
                           for i in range(n)])
    labels = np.stack([load_scene(scene_file(i), asset_root=asset_root).diffuse.numpy()
                       for i in range(n)])
    mats, losses = recover_materials_batched(load_scene(scene_file(0), asset_root=asset_root),
                                             targets, rcfg, steps=steps, lr=RECOVER_LR,
                                             key=key, device=dev)
    return mats.cpu().numpy(), labels, losses


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    work = args.workdir
    os.makedirs(work, exist_ok=True)
    scenes_dir = os.path.join(work, "scenes")
    imgs_dir = os.path.join(work, "imgs")
    data_npz = os.path.join(work, "data.npz")
    gcn_npz = os.path.join(work, "gcn_params.npz")
    metrics_path = os.path.join(work, "metrics.json")
    scene_file = lambda i: os.path.join(scenes_dir, f"{i}.txt")
    img_file = lambda i: os.path.join(imgs_dir, f"{i}.png")

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_bounces=args.bounces)
    metrics = {}
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            metrics = json.load(f)
    metrics["config"] = {"n": args.n, "width": args.width, "height": args.height,
                         "spp": args.spp, "bounces": args.bounces,
                         "devices": device_names(dev)}

    def done(phase, t0, **kv):
        metrics[phase] = {"wall_s": seconds_since(t0, dev), **kv}
        write_json(metrics_path, metrics)
        log(f"[{phase}] {metrics[phase]['wall_s']:.1f}s {kv}")

    def train(adj, x, y, name):
        """train_gcn at the reference's schedule, checkpointed and resumed."""
        return train_gcn(adj, x, y, epochs=args.gcn_epochs, lr=GCN_LR, log_every=GCN_LOG_EVERY,
                         log_fn=lambda s, l: log(f"  {name} step {s}: L1 {l:.5f}"),
                         checkpoint_path=os.path.join(work, f"{name}_train_ckpt.npz"),
                         checkpoint_every=GCN_LOG_EVERY, resume=True, device=dev)

    if "generate" in phases:
        t0 = time.time()
        generate_files(args.n, cfg, scenes_dir=scenes_dir, imgs_dir=imgs_dir,
                       asset_root=args.asset_root, seed=0, device=dev)
        done("generate", t0, scenes=args.n, samples_per_render=cfg.n_samples)

    if "dataset" in phases:
        t0 = time.time()
        parts = [generate_data(scene_file(i), img_file(i), cfg, asset_root=args.asset_root,
                               device=dev) for i in range(args.n)]
        w, pixel, light, labels = (np.stack(t) for t in zip(*parts))
        np.savez(data_npz, w=w, pixel=pixel, light=light, labels=labels)
        done("dataset", t0, scenes=args.n, out=data_npz)

    if "train" in phases:
        t0 = time.time()
        adj, x, y = load_graphs(data_npz, slice(0, args.n), dev)
        model, loss = train(adj, x, y, "gcn")
        save_checkpoint(gcn_npz, model.state_dict(), step=args.gcn_epochs, final_loss=loss)
        with torch.no_grad():
            kd_err = float((model(adj, x) - y).abs().mean())
        done("train", t0, epochs=args.gcn_epochs, scenes=args.n, final_l1=round(loss, 5),
             mean_kd_err=round(kd_err, 5))

    if "train0" in phases:
        # The reference's exact experiment: scene 0 alone (ipt.py:100), then
        # scene 0 re-rendered with the predicted Kd (ipt.py:127-140).
        t0 = time.time()
        adj0, x0, y0 = load_graphs(data_npz, 0, dev)
        model0, loss0 = train(adj0, x0, y0, "gcn0")
        save_checkpoint(os.path.join(work, "gcn0_params.npz"), model0.state_dict(),
                        step=args.gcn_epochs, final_loss=loss0)
        with torch.no_grad():
            preds0 = model0(adj0, x0)
        kd_err0 = float((preds0 - y0).abs().mean())
        preds0_dir = os.path.join(work, "preds0")
        os.makedirs(preds0_dir, exist_ok=True)
        pred_png = os.path.join(preds0_dir, "0_pred.png")
        shutil.copy(img_file(0), os.path.join(preds0_dir, "0_true.png"))
        render_with_materials(scene_file(0), pred_png, preds0, cfg, asset_root=args.asset_root,
                              device=dev)
        done("train0", t0, epochs=args.gcn_epochs, final_l1=round(loss0, 5),
             kd_err=round(kd_err0, 5), psnr_true_vs_pred=round(psnr_files(img_file(0),
                                                                          pred_png), 2))

    if "evaluate" in phases:
        t0 = time.time()
        model = load_gcn(gcn_npz, dev)
        preds_dir = os.path.join(work, "preds")
        os.makedirs(preds_dir, exist_ok=True)
        psnrs = []
        for i in range(args.eval_scenes):
            adj, x, _ = load_graphs(data_npz, i, dev)
            with torch.no_grad():
                preds = model(adj, x)
            pred_png = os.path.join(preds_dir, f"{i}_pred.png")
            shutil.copy(img_file(i), os.path.join(preds_dir, f"{i}_true.png"))
            render_with_materials(scene_file(i), pred_png, preds, cfg,
                                  asset_root=args.asset_root, device=dev)
            psnrs.append(psnr_files(img_file(i), pred_png))
        done("evaluate", t0, scenes=args.eval_scenes,
             psnr_true_vs_pred=[round(p, 2) for p in psnrs])

    if "recover" in phases:
        t0 = time.time()
        rcfg = cfg.with_(width=args.recover_res, height=args.recover_res, spp=args.recover_spp)
        mats, labels, losses = recover(work, args.recover_n, rcfg, args.recover_steps,
                                       args.asset_root, dev)
        err = float(np.abs(mats - labels).mean())
        done("recover", t0, scenes=args.recover_n, steps=args.recover_steps,
             mean_kd_err=round(err, 5), final_loss=round(losses[-1], 6))

    print(json.dumps(metrics, indent=1), flush=True)
    return metrics


if __name__ == "__main__":
    main()

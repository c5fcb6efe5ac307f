"""Command-line interface of the port (the counterpart of the JAX package's
cli.py; the reference workflow of ipt.py:86-140 is generate -> extract-graph
-> train-gcn -> evaluate).

  render         forward-render a scene file to a PNG (--profile: a trace)
  generate       write n scene files and render their PNGs
  extract-graph  transport-graph extraction -> npz
  graph-viz      transport graph -> coloured mesh.ply and lines.ply
  train-gcn      train the GCN material regressor on extracted graphs
  recover        gradient-based material recovery of one scene
  make-dataset   extract the graphs of scenes 0..n-1 into one npz
  recover-batch  batched recovery of scenes 0..n-1 (scene 0's geometry)
  evaluate       re-render with the GCN's predicted Kd into preds/ and zip it

Run: python -m inverse_path_tracer_torch.cli <command> -h

Arguments and output files are the JAX CLI's, except:

  * every command runs on the card, or on the CPU only with --cpu; without
    a card and without --cpu it raises before it writes anything;
  * --asset-root defaults to the in-repo ASSET_ROOT;
  * --tile defaults to RenderConfig.tile_size (2^20 samples a launch);
  * --backend takes auto (the kernels on the card, their plain versions on
    the CPU) or plain;
  * images are read and written by utils/png.py, with no imaging package;
  * evaluate takes a checkpoint of this CLI's train-gcn or one written by
    the JAX package (read by convert.read_jax_checkpoint);
  * --seed is an integer key of ops/rng.py, not a jax.random key;
  * --intersect bvh loads the scenes that render, recover and
    recover-batch read with their BVH (load_scene(with_bvh=True)), and the
    pipeline's steps do too (data/pipeline.py), so that the BVH route
    (RenderConfig.intersect) is taken; the JAX CLI attaches no BVH, so its
    flag has no scene to act on;
  * recover and recover-batch take --shard and --coordinator/
    --num-processes/--process-id, as the JAX CLI does: every process runs
    the same command with its own --process-id, init_distributed joins
    them (parallel/multihost.py; the backend is printed with the
    "multihost:" line: nccl with a card per process, gloo on the CPU or
    when processes share a card) and --shard splits the rays over them.
    As in the JAX CLI, every process writes its --out and its log.

Left out:

  * --rng: external mode needs rays supplied by the caller;
  * --grad-mode, --pair-sweep and --stage-loop: TPU measurement gates with
    no counterpart here (config.py);
"""

from __future__ import annotations

import argparse
import os
import shutil
import zipfile

import numpy as np
import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.render.forward import resolve_device
from inverse_path_tracer_torch.scene.build import ASSET_ROOT


def _cfg_from_args(args) -> RenderConfig:
    return RenderConfig(
        width=args.width,
        height=args.height,
        spp=args.spp,
        max_bounces=args.bounces,
        tile_size=args.tile,
        p_rr=args.p_rr,
        reference_quirks=not args.no_quirks,
        backend=args.backend,
        wavefront=args.wavefront,
        stage_bounces=args.stage_bounces,
        cluster_k=args.cluster_k,
        bin_cells=args.bin_cells,
        tri_order=args.tri_order,
        intersect=args.intersect,
    )


def _load(args, path: str):
    """The scene file at `path`, with its BVH under --intersect bvh."""
    from inverse_path_tracer_torch.scene.build import load_scene

    return load_scene(path, asset_root=args.asset_root, with_bvh=args.intersect == "bvh")


def _add_render_args(p: argparse.ArgumentParser, width=512, height=512, spp=64):
    p.add_argument("--width", type=int, default=width)
    p.add_argument("--height", type=int, default=height)
    p.add_argument("--spp", type=int, default=spp)
    p.add_argument("--bounces", type=int, default=16)
    p.add_argument("--tile", type=int, default=RenderConfig.tile_size,
                   help="samples per kernel launch")
    p.add_argument("--p-rr", type=float, default=0.9)
    p.add_argument("--no-quirks", action="store_true",
                   help="use the physically-corrected estimator")
    p.add_argument("--backend", default="auto", choices=("auto", "plain"),
                   help="auto = the CUDA kernels on the card, their plain versions on the CPU")
    p.add_argument("--wavefront", default="auto", choices=("auto", "mega", "staged"),
                   help="bounce-loop organisation (auto = staged on clustered scenes)")
    p.add_argument("--cluster-k", dest="cluster_k", type=int, default=0,
                   help="cluster width for the clustered sweep (0 = default)")
    p.add_argument("--bin-cells", dest="bin_cells", type=int, default=2,
                   help="origin-binning cells per axis (staged wavefront)")
    p.add_argument("--stage-bounces", dest="stage_bounces", type=int, default=4,
                   help="bounces per stage (staged wavefront)")
    p.add_argument("--tri-order", dest="tri_order", default="morton",
                   choices=("morton", "file"),
                   help="kernel-internal triangle order for clustered scenes")
    p.add_argument("--intersect", default="auto", choices=("auto", "brute", "bvh"),
                   help="closest-hit search of the render (bvh = BVH traversal)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--asset-root", default=ASSET_ROOT)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")


def _add_dist_args(p: argparse.ArgumentParser):
    """Multi-process flags: every process runs the same command with its own
    --process-id; --shard splits the rays over the processes."""
    p.add_argument("--shard", action="store_true",
                   help="split the rays over the processes (one rank without --coordinator)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (starts the process group)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _device(args) -> torch.device:
    """The card, or the CPU with --cpu; raises when neither is possible."""
    return resolve_device("cpu" if args.cpu else None)


def _mesh(args):
    """The mesh of the process group's ranks under --shard (one rank without
    --coordinator), else None."""
    from inverse_path_tracer_torch.parallel.shard import make_mesh

    return make_mesh(device="cpu" if args.cpu else None) if args.shard else None


def cmd_render(args):
    from inverse_path_tracer_torch.render.forward import render_to_png
    from inverse_path_tracer_torch.utils.profiling import profile_trace

    dev = _device(args)
    scene = _load(args, args.scene)
    cfg = _cfg_from_args(args)
    with profile_trace(args.profile):
        render_to_png(scene.diffuse, scene, args.seed, cfg, args.out, device=dev)
    print(f"wrote {args.out} ({cfg.width}x{cfg.height}, {cfg.spp} spp)")
    if args.profile:
        print(f"trace -> {args.profile} (open in chrome://tracing or Perfetto)")


def cmd_generate(args):
    from inverse_path_tracer_torch.data.pipeline import generate_files

    dev = _device(args)
    cfg = _cfg_from_args(args)
    generate_files(args.n, cfg, scenes_dir=args.scenes_dir, imgs_dir=args.imgs_dir,
                   asset_root=args.asset_root, seed=args.seed, device=dev)
    print(f"wrote {args.n} scenes to {args.scenes_dir}/ and renders to {args.imgs_dir}/")


def cmd_extract_graph(args):
    from inverse_path_tracer_torch.data.pipeline import generate_data

    dev = _device(args)
    cfg = _cfg_from_args(args)
    w, pixel, light, labels = generate_data(args.scene, args.image, cfg,
                                            asset_root=args.asset_root, device=dev)
    np.savez(args.out, w=w, pixel=pixel, light=light, labels=labels)
    print(f"wrote {args.out}: w{w.shape} pixel{pixel.shape} labels{labels.shape}")


def _load_graph(path: str, device):
    """(adjacency, node features, labels) of an extract-graph npz."""
    from inverse_path_tracer_torch.models.gcn import build_dense_graph

    with np.load(path) as d:
        w, pixel, labels = (torch.from_numpy(np.array(d[k])).to(device)
                            for k in ("w", "pixel", "labels"))
    adj, feats = build_dense_graph(w, pixel)
    return adj, feats, labels


def cmd_train_gcn(args):
    from inverse_path_tracer_torch.models.gcn import train_gcn
    from inverse_path_tracer_torch.utils.checkpoint import save_checkpoint
    from inverse_path_tracer_torch.utils.metrics import MetricsLogger

    dev = _device(args)
    graphs = [_load_graph(path, dev) for path in args.graphs]
    adj, x, y = ((torch.stack(t) if len(t) > 1 else t[0]) for t in zip(*graphs))
    logger = MetricsLogger(args.log)
    try:
        model, loss = train_gcn(
            adj, x, y, epochs=args.epochs, lr=args.lr, log_every=args.log_every,
            log_fn=lambda s, l: logger.log(step=s, loss=l),
            checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
            resume=args.resume, seed=args.seed, device=dev)
    finally:
        logger.close()
    save_checkpoint(args.out, model.state_dict(), step=args.epochs, final_loss=loss)
    print(f"final L1 loss {loss:.5f}; checkpoint -> {args.out}")


def _logger_every(logger, every: int):
    return lambda s, l: logger.log(step=s, loss=l) if s % every == 0 else None


def cmd_recover(args):
    from inverse_path_tracer_torch.data.pipeline import load_image01, render_with_materials
    from inverse_path_tracer_torch.models.recover import recover_materials
    from inverse_path_tracer_torch.utils.metrics import MetricsLogger

    dev = _device(args)
    mesh = _mesh(args)
    scene = _load(args, args.scene)
    cfg = _cfg_from_args(args)
    target = load_image01(args.image)
    logger = MetricsLogger(args.log)
    try:
        mats, _ = recover_materials(
            scene, target, cfg, steps=args.steps, lr=args.lr, key=args.seed,
            log_fn=_logger_every(logger, args.log_every),
            checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
            resume=args.resume, device=dev, mesh=mesh)
    finally:
        logger.close()
    mats = mats.cpu()
    err = (mats - scene.diffuse).abs()
    print(f"recovered materials: mean |Kd err| vs scene labels = {float(err.mean()):.4f}")
    np.save(args.out, mats.numpy())
    if args.render_out:
        render_with_materials(args.scene, args.render_out, mats, cfg,
                              asset_root=args.asset_root, device=dev)
        print(f"re-rendered with recovered materials -> {args.render_out}")


def cmd_make_dataset(args):
    """Extract the transport graphs of scenes 0..n-1 into one npz (the
    reference's torch.save(data, 'data.pt'), ipt.py:98)."""
    from inverse_path_tracer_torch.data.pipeline import generate_data

    dev = _device(args)
    cfg = _cfg_from_args(args)
    parts = []
    for i in range(args.n):
        parts.append(generate_data(os.path.join(args.scenes_dir, f"{i}.txt"),
                                   os.path.join(args.imgs_dir, f"{i}.png"), cfg,
                                   asset_root=args.asset_root, device=dev))
        print(f"scene {i}: graph ok", flush=True)
    w, pixel, light, labels = (np.stack(t) for t in zip(*parts))
    np.savez(args.out, w=w, pixel=pixel, light=light, labels=labels)
    print(f"wrote {args.out} ({args.n} scenes)")


def cmd_recover_batch(args):
    """Batched recovery of scenes 0..n-1 (BASELINE configs #4/#5): scene 0's
    geometry, imgs/{i}.png as the targets, per-scene Kd."""
    from inverse_path_tracer_torch.data.pipeline import load_image01
    from inverse_path_tracer_torch.models.recover import recover_materials_batched
    from inverse_path_tracer_torch.scene.build import load_scene
    from inverse_path_tracer_torch.utils.metrics import MetricsLogger

    dev = _device(args)
    mesh = _mesh(args)
    cfg = _cfg_from_args(args)
    scene_files = [os.path.join(args.scenes_dir, f"{i}.txt") for i in range(args.n)]
    scene = _load(args, scene_files[0])
    targets = torch.stack([load_image01(os.path.join(args.imgs_dir, f"{i}.png"))
                           for i in range(args.n)])
    labels = np.stack([load_scene(f, asset_root=args.asset_root).diffuse.numpy()
                       for f in scene_files])
    logger = MetricsLogger(args.log)
    try:
        mats, _ = recover_materials_batched(
            scene, targets, cfg, steps=args.steps, lr=args.lr, key=args.seed,
            log_fn=_logger_every(logger, args.log_every), device=dev, mesh=mesh)
    finally:
        logger.close()
    mats = mats.cpu().numpy()
    err = np.abs(mats - labels).mean(axis=(1, 2))
    print(f"mean |Kd err| per scene: {np.round(err, 4).tolist()}")
    print(f"overall: {err.mean():.4f}")
    np.save(args.out, mats)


def _newdir(name: str) -> None:
    """rm -rf + mkdir (reference ipt.py:11-15)."""
    if os.path.isdir(name):
        shutil.rmtree(name)
    os.makedirs(name, exist_ok=True)


def _zipdir(name: str) -> None:
    """Zip a directory tree (reference ipt.py:17-23)."""
    with zipfile.ZipFile(f"{name}.zip", "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(name):
            for fn in files:
                zf.write(os.path.join(root, fn))


def cmd_evaluate(args):
    """The reference main()'s evaluation (ipt.py:127-140): per scene, copy
    the ground-truth render to preds/i_true.png, re-render with the GCN's
    predicted Kd to preds/i_pred.png; then zip preds/."""
    from inverse_path_tracer_torch.data.pipeline import render_with_materials
    from inverse_path_tracer_torch.models.gcn import load_gcn
    from inverse_path_tracer_torch.utils.metrics import psnr
    from inverse_path_tracer_torch.utils.png import read_png

    dev = _device(args)
    cfg = _cfg_from_args(args)
    model = load_gcn(args.params, dev)
    _newdir(args.out_dir)
    for i, graph_path in enumerate(args.graphs):
        adj, feats, _ = _load_graph(graph_path, dev)
        with torch.no_grad():
            preds = model(adj, feats)
        scenefile = os.path.join(args.scenes_dir, f"{i}.txt")
        true_png = os.path.join(args.imgs_dir, f"{i}.png")
        shutil.copy(true_png, os.path.join(args.out_dir, f"{i}_true.png"))
        pred_png = os.path.join(args.out_dir, f"{i}_pred.png")
        render_with_materials(scenefile, pred_png, preds, cfg, asset_root=args.asset_root,
                              device=dev)
        a = read_png(true_png).astype(np.float32) / 255
        b = read_png(pred_png).astype(np.float32) / 255
        print(f"scene {i}: PSNR(true, pred) = {psnr(a, b):.2f} dB")
    _zipdir(args.out_dir)
    print(f"wrote {args.out_dir}/ and {args.out_dir}.zip")


def cmd_graph_viz(args):
    """Transport-graph visualisation (the reference's committed mesh.ply and
    lines.ply): extract the graph, write the coloured scene mesh and the
    coloured edge line set."""
    from inverse_path_tracer_torch.data.pipeline import load_image01
    from inverse_path_tracer_torch.render.inverse import extract_graph
    from inverse_path_tracer_torch.scene.build import load_scene
    from inverse_path_tracer_torch.utils.plyviz import write_graph_ply, write_mesh_ply

    dev = _device(args)
    cfg = _cfg_from_args(args)
    scene = load_scene(args.scene, asset_root=args.asset_root)
    target = load_image01(args.image)
    w, _pixel, _light = extract_graph(scene, target, args.seed, cfg, device=dev)
    os.makedirs(args.out_dir, exist_ok=True)
    mesh_path = os.path.join(args.out_dir, "mesh.ply")
    lines_path = os.path.join(args.out_dir, "lines.ply")
    write_mesh_ply(scene, scene.diffuse, mesh_path)
    n_edges = write_graph_ply(scene, w, lines_path, p_min=args.p_min)
    print(f"wrote {mesh_path} ({scene.n_tri} faces) and {lines_path} ({n_edges} edges)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="inverse_path_tracer_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="forward-render a scene to PNG")
    pr.add_argument("scene")
    pr.add_argument("out")
    pr.add_argument("--profile", default=None,
                    help="write a torch.profiler trace to this directory; it holds the "
                         "program's ipt.* spans, each one boolean check without --profile")
    _add_render_args(pr)
    pr.set_defaults(fn=cmd_render)

    pg = sub.add_parser("generate", help="generate n scenes + renders")
    pg.add_argument("n", type=int)
    pg.add_argument("--scenes-dir", default="scenes")
    pg.add_argument("--imgs-dir", default="imgs")
    _add_render_args(pg, width=500, height=500, spp=100)
    pg.set_defaults(fn=cmd_generate)

    pe = sub.add_parser("extract-graph", help="transport graph -> npz")
    pe.add_argument("scene")
    pe.add_argument("image")
    pe.add_argument("out")
    _add_render_args(pe)
    pe.set_defaults(fn=cmd_extract_graph)

    pgv = sub.add_parser("graph-viz", help="transport graph -> colored mesh.ply + lines.ply "
                                           "(reference artifact parity)")
    pgv.add_argument("scene")
    pgv.add_argument("image")
    pgv.add_argument("out_dir")
    pgv.add_argument("--p-min", type=float, default=1e-3,
                     help="edge weight threshold (reference ipt.py:26)")
    _add_render_args(pgv)
    pgv.set_defaults(fn=cmd_graph_viz)

    pt = sub.add_parser("train-gcn", help="train the GCN regressor")
    pt.add_argument("graphs", nargs="+", help="npz files from extract-graph")
    pt.add_argument("--out", default="gcn_params.npz")
    pt.add_argument("--epochs", type=int, default=100_000)
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--log-every", type=int, default=1000)
    pt.add_argument("--log", default=None, help="JSONL metrics path")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--cpu", action="store_true", help="run on the CPU")
    pt.add_argument("--checkpoint", default=None, help="npz checkpoint path")
    pt.add_argument("--checkpoint-every", type=int, default=0)
    pt.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    pt.set_defaults(fn=cmd_train_gcn)

    pv = sub.add_parser("recover", help="gradient-based material recovery")
    pv.add_argument("scene")
    pv.add_argument("image")
    pv.add_argument("--out", default="recovered_kd.npy")
    pv.add_argument("--render-out", default=None)
    pv.add_argument("--steps", type=int, default=200)
    pv.add_argument("--lr", type=float, default=5e-2)
    pv.add_argument("--log", default=None)
    pv.add_argument("--log-every", type=int, default=10)
    pv.add_argument("--checkpoint", default=None, help="npz checkpoint path")
    pv.add_argument("--checkpoint-every", type=int, default=0)
    pv.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    _add_render_args(pv, width=128, height=128, spp=16)
    _add_dist_args(pv)
    pv.set_defaults(fn=cmd_recover)

    pmd = sub.add_parser("make-dataset", help="cache all scene graphs to one npz")
    pmd.add_argument("n", type=int)
    pmd.add_argument("--out", default="data.npz")
    pmd.add_argument("--scenes-dir", default="scenes")
    pmd.add_argument("--imgs-dir", default="imgs")
    _add_render_args(pmd, width=500, height=500, spp=100)
    pmd.set_defaults(fn=cmd_make_dataset)

    prb = sub.add_parser("recover-batch", help="batched recovery over n scenes")
    prb.add_argument("n", type=int)
    prb.add_argument("--scenes-dir", default="scenes")
    prb.add_argument("--imgs-dir", default="imgs")
    prb.add_argument("--out", default="recovered_batch.npy")
    prb.add_argument("--steps", type=int, default=200)
    prb.add_argument("--lr", type=float, default=5e-2)
    prb.add_argument("--log", default=None)
    prb.add_argument("--log-every", type=int, default=10)
    _add_render_args(prb, width=256, height=256, spp=64)
    _add_dist_args(prb)
    prb.set_defaults(fn=cmd_recover_batch)

    pe2 = sub.add_parser("evaluate", help="render preds/ (true vs GCN-predicted) and zip")
    pe2.add_argument("params", help="GCN checkpoint from train-gcn (this CLI's or the JAX "
                                    "package's)")
    pe2.add_argument("graphs", nargs="+", help="npz graphs, one per scene")
    pe2.add_argument("--scenes-dir", default="scenes")
    pe2.add_argument("--imgs-dir", default="imgs")
    pe2.add_argument("--out-dir", default="preds")
    _add_render_args(pe2, width=500, height=500, spp=100)
    pe2.set_defaults(fn=cmd_evaluate)
    return p


def main(argv=None):
    from inverse_path_tracer_torch.parallel.multihost import init_distributed, shutdown_distributed

    args = build_parser().parse_args(argv)
    if not getattr(args, "coordinator", None):
        args.fn(args)
        return
    # Under --coordinator the process joins the group first (its summary
    # printed as the JAX CLI prints it) and leaves it at the end.
    _device(args)
    info = init_distributed(args.coordinator, args.num_processes, args.process_id,
                            device="cpu" if args.cpu else None)
    print(f"multihost: {info}", flush=True)
    try:
        args.fn(args)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()

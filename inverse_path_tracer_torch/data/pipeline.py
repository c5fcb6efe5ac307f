"""Dataset pipeline (the counterpart of the JAX package's data/pipeline.py;
reference ipt_cuda.py:115-183).

generate_files(n): write n scene files and forward-render each to a PNG.
generate_data(scenefile, imgfile): extract the transport graph of a scene
against its rendered image; returns (w, pixel, light, labels) as the
reference's createGraph + getMaterials do.
render_with_materials: re-render a scene with predicted materials.

The renders load their scene with its BVH under cfg.intersect == "bvh", so
that they take the BVH route (RenderConfig.intersect).

Keys are integer seeds (ops/rng.py); scene i of generate_files renders with
target_key(key, i), under its own stream, so that its samples differ from
those of render_with_materials and generate_data at their default key 0
(rng.fold_in(0, 0) is 0; the JAX package's keys differ too).  Entry points
run on the card unless device="cpu".
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from inverse_path_tracer_torch.config import RenderConfig
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.render.forward import render_to_png
from inverse_path_tracer_torch.render.inverse import extract_graph
from inverse_path_tracer_torch.scene.build import ASSET_ROOT, load_scene
from inverse_path_tracer_torch.scene.dsl import generate_scene_files
from inverse_path_tracer_torch.utils.png import read_png


_PRECISION_BITS = 22  # PIL's fixed-point resampling of 8-bit images


def _box_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) int64 fixed-point weights of PIL's BOX filter
    (precompute_coeffs in its Resample.c): output i averages the inputs of
    the window [int(c - s/2 + 0.5), int(c + s/2 + 0.5)) whose centres lie in
    (c - s/2, c + s/2], c = (i + 0.5) s, s = n_in / n_out, each weight
    rounded to 2^-22."""
    s = n_in / n_out
    fs = max(s, 1.0)
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        c = (i + 0.5) * s
        lo = max(int(c - 0.5 * fs + 0.5), 0)
        hi = min(int(c + 0.5 * fs + 0.5), n_in)
        x = (np.arange(lo, hi) - c + 0.5) / fs
        w[i, lo:hi] = (x > -0.5) & (x <= 0.5)
    w /= w.sum(axis=1, keepdims=True)
    return np.floor(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)


def _resample8(weights: np.ndarray, img: np.ndarray, spec: str) -> np.ndarray:
    acc = np.einsum(spec, weights, img) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255)


def load_image01(path: str, size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """PNG -> (H, W, 3) float32 tensor in [0, 1] (the reference reads the
    rendered PNG back and divides by 255, inv_scene.h:56, 74-77).  `size`
    (w, h) box-downsamples first, horizontally then vertically in PIL's
    8-bit fixed point, so the result equals Image.resize(size, Image.BOX)."""
    img = read_png(path)[..., :3].astype(np.int64)
    if size is not None and (img.shape[1], img.shape[0]) != tuple(size):
        w_out, h_out = size
        img = _resample8(_box_weights(img.shape[1], w_out), img, "xw,hwc->hxc")
        img = _resample8(_box_weights(img.shape[0], h_out), img, "yh,hxc->yxc")
    return torch.from_numpy((img / 255.0).astype(np.float32))


def target_key(key: int, i: int) -> int:
    """The render key of scene i of generate_files under `key`."""
    return rng.fold_in(rng.fold_in(key, rng.TARGET_STREAM), i)


def generate_files(
    n: int,
    cfg: RenderConfig,
    scenes_dir: str = "scenes",
    imgs_dir: str = "imgs",
    asset_root: str = ASSET_ROOT,
    seed: int = 0,
    key: Optional[int] = None,
    device=None,
) -> None:
    """Write {scenes_dir}/{i}.txt and render {imgs_dir}/{i}.png
    (ipt_cuda.py:115-134), seeded and keyed for reproducibility."""
    os.makedirs(imgs_dir, exist_ok=True)
    key = seed if key is None else key
    for i, path in enumerate(generate_scene_files(n, out_dir=scenes_dir, seed=seed)):
        scene = load_scene(path, asset_root=asset_root, with_bvh=cfg.intersect == "bvh")
        render_to_png(scene.diffuse, scene, target_key(key, i), cfg,
                      os.path.join(imgs_dir, f"{i}.png"), device=device)


def generate_data(
    scenefile: str,
    imgfile: str,
    cfg: RenderConfig,
    asset_root: str = ASSET_ROOT,
    key: int = 0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Transport graph and labels of one scene (ipt_cuda.py:136-165):
    (w (nT+1, nT), pixel (nT+1, nT, 3), light (nT+1, nT, 3), labels (nT,
    3)) as numpy arrays."""
    scene = load_scene(scenefile, asset_root=asset_root)
    target = load_image01(imgfile)
    if tuple(target.shape) != (cfg.height, cfg.width, 3):
        raise ValueError(f"image {tuple(target.shape)} != config "
                         f"{(cfg.height, cfg.width, 3)}")
    w, pixel, light = extract_graph(scene, target, key, cfg, device=device)
    pixel = pixel.cpu().numpy()
    assert not np.isnan(pixel).any()  # the reference's one sanity check
    return w.cpu().numpy(), pixel, light.cpu().numpy(), scene.diffuse.numpy()


def render_with_materials(
    scenefile: str,
    imgfile: str,
    materials,
    cfg: RenderConfig,
    asset_root: str = ASSET_ROOT,
    key: int = 0,
    device=None,
) -> torch.Tensor:
    """Re-render a scene with per-triangle diffuse `materials` (nT, 3)
    (ipt_cuda.py:167-183), write the PNG, and return the (H, W, 3) uint8
    image."""
    scene = load_scene(scenefile, asset_root=asset_root, with_bvh=cfg.intersect == "bvh")
    mats = torch.as_tensor(materials, dtype=torch.float32)
    return render_to_png(mats, scene, key, cfg, imgfile, device=device)

"""PyTorch + CUDA port of inverse_path_tracer_tpu, for NVIDIA Hopper.

It holds the forward render and its material gradient: scene loading, the
plain PyTorch ops, the hand-written CUDA kernels of the bounce loop and of
its backward (ops/kernels), the render entry points (render_range is
differentiable in the materials; loss_and_grad_range is the training path)
and single-device material recovery (models/recover.py).  float32 throughout: TF32 is switched off for matmuls
and convolutions when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from inverse_path_tracer_torch.config import CameraConfig, RenderConfig  # noqa: E402
from inverse_path_tracer_torch.convert import materials_from_numpy, scene_from_numpy  # noqa: E402
from inverse_path_tracer_torch.models.recover import recover_materials  # noqa: E402
from inverse_path_tracer_torch.render.forward import (  # noqa: E402
    RenderStats,
    camera_rays,
    grad_range,
    loss_and_grad_range,
    render_image,
    render_range,
    render_samples,
    render_to_png,
)
from inverse_path_tracer_torch.scene.build import (  # noqa: E402
    ASSET_ROOT,
    REFERENCE_CUBE_KD,
    SceneData,
    build_scene,
    load_scene,
)

__all__ = [
    "ASSET_ROOT",
    "CameraConfig",
    "REFERENCE_CUBE_KD",
    "RenderConfig",
    "RenderStats",
    "SceneData",
    "build_scene",
    "camera_rays",
    "grad_range",
    "load_scene",
    "loss_and_grad_range",
    "materials_from_numpy",
    "recover_materials",
    "render_image",
    "render_range",
    "render_samples",
    "render_to_png",
    "scene_from_numpy",
]

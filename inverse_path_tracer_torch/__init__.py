"""PyTorch + CUDA port of inverse_path_tracer_tpu, for NVIDIA Hopper.

This slice holds the forward render: scene loading, the plain PyTorch ops,
the hand-written CUDA megakernel of the bounce loop (ops/kernels) and the
render entry points.  float32 throughout: TF32 is switched off for matmuls
and convolutions when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from inverse_path_tracer_torch.config import CameraConfig, RenderConfig  # noqa: E402
from inverse_path_tracer_torch.convert import materials_from_numpy, scene_from_numpy  # noqa: E402
from inverse_path_tracer_torch.render.forward import (  # noqa: E402
    RenderStats,
    camera_rays,
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
    "load_scene",
    "materials_from_numpy",
    "render_image",
    "render_range",
    "render_samples",
    "render_to_png",
    "scene_from_numpy",
]

"""PyTorch + CUDA port of inverse_path_tracer_tpu, for NVIDIA Hopper.

It holds the forward render and its material gradient: scene loading, the
plain PyTorch ops, the hand-written CUDA kernels of the bounce loop, of its
backward and of the inverse pass (ops/kernels), the render entry points
(render_range is differentiable in the materials; loss_and_grad_range is
the training path), single-scene and batched material recovery
(models/recover.py), the reference's inverse pipeline: transport-graph
extraction (render/inverse.py), the GCN (models/gcn.py) and the dataset
steps (data/pipeline.py), and the command-line interface (cli.py).
Large scenes (assets.large_scene) run through the clustered sweep and the
staged wavefront (render/forward.py); with RenderConfig(intersect="bvh") a
scene with a BVH (assets.bvh_scene) runs through the BVH traversal.  float32 throughout: TF32 is switched
off for matmuls and convolutions when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from inverse_path_tracer_torch.assets import bvh_scene, large_scene  # noqa: E402
from inverse_path_tracer_torch.config import CameraConfig, RenderConfig, TrainConfig  # noqa: E402
from inverse_path_tracer_torch.convert import materials_from_numpy, scene_from_numpy  # noqa: E402
from inverse_path_tracer_torch.data.pipeline import (  # noqa: E402
    generate_data,
    generate_files,
    render_with_materials,
)
from inverse_path_tracer_torch.models.gcn import GCN, build_dense_graph, train_gcn  # noqa: E402
from inverse_path_tracer_torch.models.recover import (  # noqa: E402
    recover_materials,
    recover_materials_batched,
)
from inverse_path_tracer_torch.render.inverse import (  # noqa: E402
    TransportGrids,
    compress_grids,
    extract_graph,
    trace_transport_range,
)
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
    "GCN",
    "REFERENCE_CUBE_KD",
    "RenderConfig",
    "RenderStats",
    "SceneData",
    "TrainConfig",
    "TransportGrids",
    "build_dense_graph",
    "build_scene",
    "bvh_scene",
    "camera_rays",
    "compress_grids",
    "extract_graph",
    "generate_data",
    "generate_files",
    "grad_range",
    "large_scene",
    "load_scene",
    "loss_and_grad_range",
    "materials_from_numpy",
    "recover_materials",
    "recover_materials_batched",
    "render_image",
    "render_range",
    "render_samples",
    "render_to_png",
    "render_with_materials",
    "scene_from_numpy",
    "trace_transport_range",
    "train_gcn",
]

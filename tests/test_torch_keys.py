"""The dataset's render keys (data/pipeline.py target_key) on the CPU.

generate_files renders scene i under target_key(key, i), a stream of its
own (rng.TARGET_STREAM): for seeds 0-2 the keys of scenes 0-99 are distinct
and none is the default key 0 of render_with_materials and generate_data,
so that a re-render of a scene at the default key draws other samples than
its target (rng.fold_in(0, 0) is 0).
"""

import inspect

import numpy as np

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, generate_files, load_scene
from inverse_path_tracer_torch.data import pipeline
from inverse_path_tracer_torch.data.pipeline import target_key
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.utils.png import read_png


def test_target_keys_are_disjoint_from_the_default_keys():
    defaults = {inspect.signature(f).parameters["key"].default
                for f in (pipeline.render_with_materials, pipeline.generate_data)}
    assert defaults == {0} and rng.fold_in(0, 0) == 0
    for seed in range(3):
        keys = [target_key(seed, i) for i in range(100)]
        assert len(set(keys)) == 100
        assert not set(keys) & defaults
        assert keys == [rng.fold_in(rng.fold_in(seed, rng.TARGET_STREAM), i) for i in range(100)]


def test_generate_files_renders_under_the_target_keys(tmp_path, monkeypatch):
    """Scene 0's target is its render under target_key, not under key 0."""
    monkeypatch.chdir(tmp_path)
    cfg = RenderConfig(width=6, height=6, spp=2, max_bounces=3)
    generate_files(1, cfg, scenes_dir="s", imgs_dir="i", device="cpu")
    target = read_png("i/0.png")
    kd = load_scene("s/0.txt", asset_root=ASSET_ROOT).diffuse
    pipeline.render_with_materials("s/0.txt", "key0.png", kd, cfg, key=target_key(0, 0),
                                   device="cpu")
    assert np.array_equal(read_png("key0.png"), target)
    pipeline.render_with_materials("s/0.txt", "default.png", kd, cfg, device="cpu")
    assert not np.array_equal(read_png("default.png"), target)

"""The port's GCN (models/gcn.py), its conversion from the JAX checkpoint,
the dataset pipeline (data/pipeline.py) and utils/metrics.py, on the CPU.

  * GCN with artifacts/exp100/gcn0_params.npz against JAX gcn_forward on all
    100 graphs of artifacts/exp100/data.npz: within 1e-5.
  * build_dense_graph against JAX (rtol 1e-6: row sums add in another
    order), the parameter count of tests/test_gcn.py:48, one train_gcn Adam
    step against optax.adam from the same init (rtol 1e-5), bit-identical
    checkpoint/resume.
  * generate_data at 8x8/2 spp: shapes, no NaN, labels equal the scene's Kd;
    load_image01's box downsample against PIL's Image.BOX, bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from inverse_path_tracer_tpu.models import gcn as jgcn

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import (
    ASSET_ROOT,
    GCN,
    RenderConfig,
    build_dense_graph,
    generate_data,
    load_scene,
    render_to_png,
    render_with_materials,
    train_gcn,
)
from inverse_path_tracer_torch.convert import gcn_params_from_numpy, read_jax_checkpoint
from inverse_path_tracer_torch.data.pipeline import generate_files, load_image01
from inverse_path_tracer_torch.utils.metrics import MetricsLogger, psnr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "artifacts", "exp100")
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def data():
    with np.load(os.path.join(EXP, "data.npz")) as d:
        return {k: np.array(d[k]) for k in d.files}


@pytest.fixture(scope="module")
def gcn0():
    params, step = read_jax_checkpoint(os.path.join(EXP, "gcn0_params.npz"))
    assert step == 100_000 and list(params) == sorted(params)
    return params


def port_model(params):
    model = GCN()
    model.load_state_dict(gcn_params_from_numpy(params))
    return model


def test_gcn0_matches_gcn_forward_on_every_graph(data, gcn0):
    adj_j, x_j = jax.vmap(jgcn.build_dense_graph)(jnp.asarray(data["w"]), jnp.asarray(data["pixel"]))
    want = np.asarray(jax.vmap(jgcn.gcn_forward, in_axes=(None, 0, 0))(
        {k: jnp.asarray(v) for k, v in gcn0.items()}, adj_j, x_j))
    adj, x = build_dense_graph(torch.from_numpy(data["w"]), torch.from_numpy(data["pixel"]))
    with torch.no_grad():
        got = port_model(gcn0)(adj, x).numpy()
    assert got.shape == (100, 30, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The checkpoint was trained on graph 0 (artifacts/exp100/metrics.json).
    assert np.abs(got[0] - data["labels"][0]).mean() < 1e-3


def test_build_dense_graph_matches_jax(data):
    for i in (0, 17, 99):
        want = jgcn.build_dense_graph(jnp.asarray(data["w"][i]), jnp.asarray(data["pixel"][i]))
        got = build_dense_graph(torch.from_numpy(data["w"][i]), torch.from_numpy(data["pixel"][i]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    w = torch.tensor([[0.5, 0.0005, 0.5], [0.0, 0.0, 0.0], [0.2, 0.2, 0.6], [1.0, 0.0, 0.0]])
    adj, feats = build_dense_graph(w, torch.full((4, 3, 3), 0.25))
    torch.testing.assert_close(adj, torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.0, 0.0],
                                                  [0.2, 0.2, 0.6]]), rtol=0, atol=1e-6)
    assert feats.shape == (3, 3)


def test_param_count_and_init_range():
    model = GCN(seed=3).requires_grad_(False)
    n = sum(p.numel() for p in model.parameters())
    assert n == (3 * 100 + 100) + 3 * (200 * 100 + 100) + (100 * 3 + 3) == 61003
    assert float(model.lift.weight.abs().max()) <= 1 / 3 ** 0.5
    assert float(model.out.bias.abs().max()) <= 0.1
    assert torch.equal(GCN(seed=3).mpl[1].weight, model.mpl[1].weight)
    assert not torch.equal(GCN(seed=4).mpl[1].weight, model.mpl[1].weight)


def test_one_adam_step_matches_optax(data):
    params = jgcn.init_gcn(jax.random.PRNGKey(0))
    adj_j, x_j = jgcn.build_dense_graph(jnp.asarray(data["w"][0]), jnp.asarray(data["pixel"][0]))
    labels = jnp.asarray(data["labels"][0])
    opt = optax.adam(1e-4)
    step = jgcn.make_gcn_train_step(opt)
    want, _, want_loss = step(params, opt.init(params), adj_j, x_j, labels)
    model = port_model({k: np.asarray(v) for k, v in params.items()})
    adj, x = build_dense_graph(torch.from_numpy(data["w"][0]), torch.from_numpy(data["pixel"][0]))
    model, loss = train_gcn(adj, x, torch.from_numpy(data["labels"][0]), epochs=1, model=model,
                            **CPU)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-6)
    expect = gcn_params_from_numpy({k: np.asarray(v) for k, v in want.items()})
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-5, atol=1e-9, err_msg=k)


def test_train_gcn_resume_is_bit_identical(data, tmp_path):
    adj, x = build_dense_graph(torch.from_numpy(data["w"][:4]), torch.from_numpy(data["pixel"][:4]))
    labels = torch.from_numpy(data["labels"][:4])
    logged = []
    full, loss = train_gcn(adj, x, labels, epochs=40, lr=1e-3, log_every=10,
                           log_fn=lambda e, l: logged.append((e, l)), seed=5, **CPU)
    assert [e for e, _ in logged] == [10, 20, 30, 40] and logged[-1][1] == loss
    assert logged[-1][1] < logged[0][1]
    ckpt = str(tmp_path / "gcn.npz")
    train_gcn(adj, x, labels, epochs=25, lr=1e-3, seed=5, checkpoint_path=ckpt,
              checkpoint_every=10, **CPU)  # saved at 20
    resumed, loss2 = train_gcn(adj, x, labels, epochs=40, lr=1e-3, seed=99, checkpoint_path=ckpt,
                               resume=True, **CPU)
    assert loss2 == loss
    for (k, a), b in zip(full.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), k


def test_generate_data_and_rerender(tmp_path):
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=4)
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    png = str(tmp_path / "0.png")
    render_to_png(scene.diffuse, scene, 1, cfg, png, **CPU)
    w, pixel, light, labels = generate_data(SCENE0, png, cfg, key=2, **CPU)
    nt = scene.n_tri
    assert w.shape == (nt + 1, nt) and pixel.shape == light.shape == (nt + 1, nt, 3)
    assert not any(np.isnan(a).any() for a in (w, pixel, light))
    np.testing.assert_array_equal(labels, scene.diffuse.numpy())
    out = str(tmp_path / "pred.png")
    img = render_with_materials(SCENE0, out, labels, cfg, key=1, **CPU)
    assert img.dtype == torch.uint8 and os.path.exists(out)
    np.testing.assert_array_equal(load_image01(out).numpy(), load_image01(png).numpy())
    with pytest.raises(ValueError, match="config"):
        generate_data(SCENE0, png, cfg.with_(width=16, height=16), **CPU)


def test_generate_files_writes_the_jax_scene_text(tmp_path):
    from inverse_path_tracer_tpu.scene.dsl import generate_scene_files

    cfg = RenderConfig(width=4, height=4, spp=1, max_bounces=2)
    generate_files(2, cfg, scenes_dir=str(tmp_path / "s"), imgs_dir=str(tmp_path / "i"), seed=3,
                   **CPU)
    want = generate_scene_files(2, out_dir=str(tmp_path / "j"), seed=3)
    for i, path in enumerate(want):
        with open(path) as a, open(tmp_path / "s" / f"{i}.txt") as b:
            assert a.read() == b.read()
        assert load_image01(str(tmp_path / "i" / f"{i}.png")).shape == (4, 4, 3)


@pytest.mark.parametrize("size", [(100, 100), (64, 48)])
def test_load_image01_box_matches_pil(size):
    from PIL import Image

    path = os.path.join(REPO, "artifacts", "bench_golden_0.png")
    want = np.asarray(Image.open(path).convert("RGB").resize(size, Image.BOX), np.float32) / 255
    got = load_image01(path, size=size).numpy()
    assert got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, want)


def test_metrics(tmp_path):
    a = np.zeros((4, 4, 3))
    assert psnr(a, a) == float("inf")
    assert abs(psnr(a, a + 0.1) - 20.0) < 1e-9
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path, stream=open(os.devnull, "w"))
    log.log(step=1, loss=0.5)
    log.close()
    with open(path) as f:
        line = json.loads(f.read())
    assert line["step"] == 1 and line["loss"] == 0.5 and "t" in line

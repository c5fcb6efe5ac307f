"""The experiment modules of the port (inverse_path_tracer_torch/experiments/)
against the JAX package's scripts/gate_recover100.py, run_recover100.py and
full_pipeline.py, on the CPU at small sizes.

  * The gate on shared rays: JAX's camera_rays under PRNGKey(7) at 64x64 on
    the in-repo scene 0, fed to the port's direct_pixel_counts: the counts
    bit-equal to the JAX script's intersect_fast bincount.  The same on a
    clustered scene 0 (internal triangle rows mapped back).
  * Each package's own rays at 256x256: the two gates equal each other and
    {0-15, 20-23}, the threshold 16, the camera-hidden cube triangles 0 px,
    and every count within max(10 px, 3%) of JAX's (the two packages draw
    their jitter from different RNGs).
  * assemble_hybrid and gated_report against the JAX script's formulas on
    seeded arrays.
  * recover100 on 2 scenes at 16x16/4 spp/4 bounces, graphs at 16x16/4 spp,
    3 steps from the GCN of artifacts/exp100/gcn_params.npz: the JAX
    recover100_256 block's keys; a run cut after 2 steps and started again
    ends bit-identical to an uninterrupted one, losses.jsonl included; so
    does a 4-step run cut before its first checkpoint or between two.
  * full_pipeline with every phase at a tiny size: the JAX phase names and
    keys of artifacts/exp100/metrics.json.
  * full_pipeline's recovery (batched, from Kd 0.5, lr 5e-2) on the in-repo
    fixture errs alike in both packages on the same targets.
  * Without a card and without --cpu, each module (python -m) fails and
    writes nothing.
  * What the in-repo data are: scenes/ is the GCN's training set (the
    seed-0 generated scenes), and the JAX GCN errs on the fixture's graphs
    in both packages alike.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.models import recover as jrec
from inverse_path_tracer_tpu.render.forward import camera_rays as jax_camera_rays
from inverse_path_tracer_tpu.render.forward import render_image as jax_render_image
from inverse_path_tracer_tpu.render.inverse import extract_graph as jax_extract_graph

import torch_threads  # noqa: F401

import inverse_path_tracer_torch.models.recover as recover_mod
from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, extract_graph, load_scene, \
    recover_materials_batched, render_image
from inverse_path_tracer_torch.experiments import full_pipeline, gate, recover100
from inverse_path_tracer_torch.models.gcn import build_dense_graph, load_gcn
from inverse_path_tracer_torch.ops.kernels import clusters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
EXP100_METRICS = os.path.join(REPO, "artifacts", "exp100", "metrics.json")
GATE = set(range(16)) | {20, 21, 22, 23}
HIDDEN = (18, 19, 24, 25, 26, 27, 28, 29)
# The keys the JAX script's gate writes into a recover100 block.
GATE_KEYS = {"observability", "observability_gate_tris", "gated_mean_kd_err",
             "gated_mean_kd_err_cube", "gated_per_face_cube_err", "per_face_cube_err",
             "gcn_init_per_face_cube_err"}

spec = importlib.util.spec_from_file_location(
    "gate_recover100", os.path.join(REPO, "scripts", "gate_recover100.py"))
jgate = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jgate)


@pytest.fixture(scope="module")
def scenes():
    return jipt.load_scene(SCENE0, asset_root=ASSET_ROOT), load_scene(SCENE0,
                                                                       asset_root=ASSET_ROOT)


@pytest.fixture(scope="module")
def jax_metrics():
    with open(EXP100_METRICS) as f:
        return json.load(f)


def jax_gate_rays(js, res):
    """JAX's primary rays under PRNGKey(7), as the port takes rays: (3, n)."""
    cfg = jipt.RenderConfig(width=res, height=res, spp=1, max_bounces=1)
    p, d = jax_camera_rays(js, cfg, jax.random.PRNGKey(7),
                           jnp.arange(res * res, dtype=jnp.int32))
    return np.asarray(p).T, np.asarray(d).T


def test_direct_pixel_counts_on_jax_rays_are_bit_equal(scenes):
    js, ts = scenes
    want = jgate.direct_pixel_counts(js, 64)
    got = gate.direct_pixel_counts(ts, 64, device="cpu", rays=jax_gate_rays(js, 64))
    assert got.dtype == np.int64 and got.shape == (30,)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 64 * 64  # the box is closed: every pixel hits


def test_direct_pixel_counts_map_clustered_rows_back(scenes, monkeypatch):
    js, ts = scenes
    rays = jax_gate_rays(js, 64)
    dense = gate.direct_pixel_counts(ts, 64, device="cpu", rays=rays)
    monkeypatch.setattr(clusters, "CLUSTER_MIN_TP", 8)
    perm = clusters.kernel_perm(ts, gate.gate_config(64))
    assert perm is not None and not torch.equal(perm, torch.arange(30))
    np.testing.assert_array_equal(gate.direct_pixel_counts(ts, 64, device="cpu", rays=rays),
                                  dense)


def test_gates_agree_at_256(scenes):
    js, ts = scenes
    g_jax, px_jax, thr_jax = jgate.compute_gate(js, 256)
    g, px, thr = gate.compute_gate(ts, 256, device="cpu")
    assert thr == thr_jax == 16
    np.testing.assert_array_equal(g, g_jax)
    assert set(np.nonzero(g)[0].tolist()) == GATE
    for t in HIDDEN:
        assert px[t] == 0 and px_jax[t] == 0
    assert np.all(np.abs(px - px_jax) <= np.maximum(10, 0.03 * px_jax))


def test_hybrid_and_report_follow_the_jax_formulas(jax_metrics):
    r = np.random.default_rng(3)
    refined, gcn, labels = (r.uniform(size=(4, 30, 3)).astype(np.float32) for _ in range(3))
    gate_bool = r.uniform(size=30) < 0.5
    direct_px = r.integers(0, 200, size=30)
    hybrid = gate.assemble_hybrid(gate_bool, refined, gcn)
    np.testing.assert_array_equal(hybrid, np.where(gate_bool[None, :, None], refined, gcn))
    m = gate.gated_report({}, gate_bool, direct_px, 16, refined, gcn, labels)
    # The JAX script's phase 3 (scripts/gate_recover100.py:129-158).
    err = np.abs(hybrid - labels)
    per_face = lambda e: [round(float(v), 4) for v in e[:, 18:, :].mean(axis=(0, 2))]
    assert m["per_face_cube_err"] == per_face(np.abs(refined - labels))
    assert m["gcn_init_per_face_cube_err"] == per_face(np.abs(gcn - labels))
    assert m["observability"]["direct_px"] == [int(c) for c in direct_px]
    assert m["observability"]["threshold_px"] == 16
    assert m["observability_gate_tris"] == [int(t) for t in np.nonzero(gate_bool)[0]]
    assert m["gated_mean_kd_err"] == float(err.mean())
    assert m["gated_mean_kd_err_cube"] == float(err[:, 18:, :].mean())
    assert m["gated_per_face_cube_err"] == per_face(err)
    assert set(m) == GATE_KEYS and GATE_KEYS <= set(jax_metrics["recover100_256"])
    assert set(m["observability"]) == set(jax_metrics["recover100_256"]["observability"])


def test_the_in_repo_scenes_are_the_gcn_training_set(tmp_path, jax_metrics):
    """scenes/ is generate_scene_files(100, seed=0), the scenes of the JAX
    full_pipeline's dataset (artifacts/exp100/data.npz, on which
    gcn_params.npz was trained), not the reference's 100 files that the JAX
    recover100 runs recovered: their cached GCN predictions are as far from
    scenes/' cube Kd as a guess, while JAX reported 0.060 on their own."""
    from inverse_path_tracer_torch.scene.dsl import generate_scene_files

    for i, path in enumerate(generate_scene_files(100, out_dir=str(tmp_path), seed=0)):
        with open(path) as a, open(os.path.join(REPO, "scenes", f"{i}.txt")) as b:
            assert a.read() == b.read(), i
    labels = gate.scene_labels(100, os.path.join(REPO, "scenes"), ASSET_ROOT)
    with np.load(os.path.join(REPO, "artifacts", "exp100", "data.npz")) as d:
        np.testing.assert_array_equal(d["labels"], labels)
    init = np.load(os.path.join(REPO, "artifacts", "exp100", "gcn_init_256.npy"))
    assert np.abs(init - labels)[:, 18:].mean() > 0.25
    assert jax_metrics["recover100_256"]["gcn_init_err_cube"] < 0.07


def test_the_jax_gcn_misses_on_the_fixture_in_both_packages(scenes):
    """artifacts/exp100/gcn_params.npz was trained on graphs extracted on the
    reference's asset tree (artifacts/exp100/data.npz, mean Kd error 0.0217
    there).  On the in-repo fixture's graphs of scene 0 (64x64/16 spp/16
    bounces) it errs far more, by the same amount whichever package
    extracts them: the fixture's geometry, not the port, sets the error."""
    js, ts = scenes
    model = load_gcn(os.path.join(REPO, "artifacts", "exp100", "gcn_params.npz"), "cpu")
    kd_err = lambda w, pixel: float(
        (model(*build_dense_graph(torch.as_tensor(np.array(w)), torch.as_tensor(np.array(pixel))))
         - ts.diffuse).abs().mean())
    with np.load(os.path.join(REPO, "artifacts", "exp100", "data.npz")) as d, torch.no_grad():
        reference = kd_err(d["w"][0], d["pixel"][0])
    cfg = RenderConfig(width=64, height=64, spp=16, max_bounces=16)
    img = render_image(ts.diffuse, ts, 1, cfg, device="cpu")
    w, pixel, _ = extract_graph(ts, img, 500, cfg, device="cpu")
    jcfg = jipt.RenderConfig(width=64, height=64, spp=16, max_bounces=16, tile_size=1 << 15)
    jimg = jax_render_image(js.diffuse, js, jax.random.PRNGKey(1), jcfg)
    jw, jpixel, _ = jax_extract_graph(js, jimg, jax.random.PRNGKey(500), jcfg)
    with torch.no_grad():
        port, jax_err = kd_err(w, pixel), kd_err(jw, jpixel)
    print(f"GCN Kd error: reference graph {reference:.4f}, fixture port {port:.4f}, "
          f"fixture JAX {jax_err:.4f}")
    assert reference < 0.03
    assert port > 0.05 and jax_err > 0.05 and abs(port - jax_err) < 0.01


R100_ARGS = ["--scenes", "2", "--res", "16", "--spp", "4", "--steps", "3", "--init", "gcn",
             "--avg", "2", "--cpu"]
# recover100's fixed settings, cut to the tests' size.
R100_SMALL = dict(BOUNCES=4, GRAPH_RES=16, GRAPH_SPP=4, CHECKPOINT_EVERY=2)


def small_r100(mp):
    for name, value in R100_SMALL.items():
        mp.setattr(recover100, name, value)


def _losses(workdir):
    with open(os.path.join(workdir, "losses.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def r100_whole(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("r100") / "whole")
    with pytest.MonkeyPatch.context() as mp:
        small_r100(mp)
        return work, recover100.main(R100_ARGS + ["--workdir", work])


@pytest.fixture(scope="module")
def r100_whole4(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("r100") / "whole4")
    with pytest.MonkeyPatch.context() as mp:
        small_r100(mp)
        return work, recover100.main(R100_ARGS + ["--steps", "4", "--workdir", work])


def test_recover100_writes_the_jax_block(r100_whole, jax_metrics):
    work, m = r100_whole
    want = jax_metrics["recover100_256"]
    assert set(m) == set(want)
    assert set(want["config"]) <= set(m["config"])
    assert m["config"]["devices"] == ["cpu"] and m["config"]["init"] == "gcn"
    with open(os.path.join(work, "metrics.json")) as f:
        assert json.load(f)["recover100"] == m
    for name in ("recovered.npy", "gcn_init.npy", "recovered_gated.npy", "0_pred.png",
                 "0_true.png", "1.png", "ckpt.npz"):
        assert os.path.exists(os.path.join(work, name)), name
    refined = np.load(os.path.join(work, "recovered.npy"))
    assert refined.shape == (2, 30, 3) and np.isfinite(refined).all()
    assert [line["step"] for line in _losses(work)] == [0, 1, 2]
    gated = np.load(os.path.join(work, "recovered_gated.npy"))
    g = np.zeros(30, bool)
    g[m["observability_gate_tris"]] = True
    np.testing.assert_array_equal(
        gated, gate.assemble_hybrid(g, refined, np.load(os.path.join(work, "gcn_init.npy"))))


class Cut(Exception):
    """Stands for a run cut between two steps."""


def cut_and_resume(args, cut, monkeypatch):
    """recover100 cut after `cut` steps, then started again on its workdir;
    the metrics of the resumed run."""
    small_r100(monkeypatch)
    step = recover_mod.batched_step
    calls = []

    def cut_after(*a, **kw):
        calls.append(1)
        if len(calls) == cut + 1:
            raise Cut
        return step(*a, **kw)

    monkeypatch.setattr(recover_mod, "batched_step", cut_after)
    with pytest.raises(Cut):
        recover100.main(args)
    assert len(calls) == cut + 1
    assert not os.path.exists(os.path.join(args[-1], "recovered.npy"))
    monkeypatch.setattr(recover_mod, "batched_step", step)
    return recover100.main(args)


def assert_resumed_equals_whole(work, m, whole, m_whole):
    for name in ("recovered.npy", "recovered_gated.npy", "gcn_init.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(work, name)),
                                      np.load(os.path.join(whole, name)), err_msg=name)
    assert _losses(work) == _losses(whole)
    for k, v in m_whole.items():
        if not k.endswith("wall_s"):
            assert m[k] == v, k


def test_recover100_resumed_is_bit_identical(r100_whole, tmp_path, monkeypatch):
    """Cut on the checkpoint of step 2."""
    work = str(tmp_path / "cut")
    m = cut_and_resume(R100_ARGS + ["--workdir", work], 2, monkeypatch)
    assert_resumed_equals_whole(work, m, *r100_whole)


@pytest.mark.parametrize("cut", [1, 3])
def test_recover100_resumed_between_checkpoints_is_bit_identical(r100_whole4, tmp_path,
                                                                  monkeypatch, cut):
    """Cut before the first checkpoint (step 2) or past it: the resumed run
    takes the steps after the checkpoint again, and losses.jsonl holds each
    step once."""
    work = str(tmp_path / "cut")
    m = cut_and_resume(R100_ARGS + ["--steps", "4", "--workdir", work], cut, monkeypatch)
    assert [line["step"] for line in _losses(work)] == [0, 1, 2, 3]
    assert_resumed_equals_whole(work, m, *r100_whole4)


def test_full_pipeline_writes_the_jax_phases(tmp_path, jax_metrics):
    work = str(tmp_path / "fp")
    m = full_pipeline.main(["--workdir", work, "--n", "3", "--width", "16", "--height", "16",
                            "--spp", "4", "--bounces", "4", "--gcn-epochs", "20",
                            "--recover-n", "2", "--recover-steps", "2", "--recover-res", "8",
                            "--recover-spp", "2", "--eval-scenes", "2", "--cpu"])
    phases = ("config", "generate", "dataset", "train", "train0", "evaluate", "recover")
    assert set(m) == set(phases)
    for phase in phases:
        assert set(m[phase]) == set(jax_metrics[phase]), phase
    with open(os.path.join(work, "metrics.json")) as f:
        assert json.load(f) == m
    assert m["generate"]["samples_per_render"] == 16 * 16 * 4
    assert len(m["evaluate"]["psnr_true_vs_pred"]) == 2
    for name in ("data.npz", "gcn_params.npz", "gcn0_params.npz", "preds0/0_pred.png",
                 "preds/1_pred.png", "scenes/2.txt", "imgs/2.png"):
        assert os.path.exists(os.path.join(work, name)), name
    assert all(np.isfinite(m[p][k]) for p, k in (("train", "mean_kd_err"),
                                                  ("train0", "kd_err"),
                                                  ("recover", "mean_kd_err")))


def test_batched_recovery_errs_alike_in_both_packages_on_the_fixture(scenes):
    """full_pipeline's recovery (batched, from Kd 0.5, lr 5e-2) of scenes 0
    and 1 of scenes/ on the in-repo fixture, from the same targets (the
    port's renders at 16x16/64 spp/8 bounces), 40 steps at 16x16/4 spp:
    JAX's recover_materials_batched and the port's, keys 0 and 1 each.  The
    two packages draw different samples, so their mean Kd errors over the
    two keys are held to the experiment's bound, each within 1.15x of the
    other's."""
    js, ts = scenes
    scenes2 = [load_scene(os.path.join(REPO, "scenes", f"{i}.txt"), asset_root=ASSET_ROOT)
               for i in range(2)]
    labels = np.stack([s.diffuse.numpy() for s in scenes2])
    tcfg = RenderConfig(width=16, height=16, spp=64, max_bounces=8)
    targets = torch.stack([render_image(s.diffuse, s, 100 + i, tcfg, device="cpu")
                           for i, s in enumerate(scenes2)])
    cfg = tcfg.with_(spp=4)
    jcfg = jipt.RenderConfig(width=16, height=16, spp=4, max_bounces=8, tile_size=1024,
                             backend="xla")
    port, jax_err = [], []
    for key in (0, 1):
        m, _ = recover_materials_batched(ts, targets, cfg, steps=40, lr=5e-2, key=key,
                                         device="cpu")
        port.append(float(np.abs(m.numpy() - labels).mean()))
        jm, _ = jrec.recover_materials_batched(js, jnp.asarray(targets.numpy()), jcfg, steps=40,
                                               lr=5e-2, key=jax.random.PRNGKey(key))
        jax_err.append(float(np.abs(np.asarray(jm) - labels).mean()))
    print(f"mean Kd error, keys 0 and 1: port {port}, JAX {jax_err}")
    a, b = np.mean(port), np.mean(jax_err)
    assert a <= 1.15 * b and b <= 1.15 * a


@pytest.mark.parametrize("name", ["recover100", "full_pipeline", "gate"])
def test_experiments_need_a_card_or_cpu(tmp_path, name):
    work = tmp_path / "work"
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", f"inverse_path_tracer_torch.experiments.{name}",
                          "--workdir", str(work)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert os.listdir(tmp_path) == []

"""The port's command-line interface (cli.py) and profiling hooks on the CPU.

  * The reference workflow generate -> extract-graph -> train-gcn ->
    evaluate (the JAX test_cli_full_pipeline recipe, tests/test_workflow.py)
    through the port's cli.main with --cpu and through the JAX package's
    cli.main on the same arguments: the scene files byte-identical, the
    graphs' npz keys, shapes and dtypes equal (the renders differ: the two
    packages draw their samples from different RNGs), and the JAX test's
    gates on the port's outputs.
  * recover, recover-batch, make-dataset, graph-viz and render --profile
    write what they promise (the trace holds the ipt.* spans); evaluate also reads the JAX package's
    checkpoint of artifacts/exp100.
  * Without --cpu and without a card, every command raises before it writes.
  * recover --shard --coordinator in two processes (the JAX package's
    tests/test_multihost.py on the in-repo scene): both join the group of
    two and write bit-identical Kd; --shard alone is one rank.
"""

import json
import os
import socket
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from inverse_path_tracer_tpu import cli as jcli

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, cli, load_scene
from inverse_path_tracer_torch.utils.plyviz import read_ply_counts
from inverse_path_tracer_torch.utils.profiling import profile_trace, span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_ARGS = ["--width", "24", "--height", "24", "--spp", "4", "--bounces", "4",
            "--tile", "576", "--asset-root", ASSET_ROOT]
CPU_ARGS = CFG_ARGS + ["--cpu"]


def run_pipeline(main, cfg_args, train_args):
    main(["generate", "2", "--scenes-dir", "scenes", "--imgs-dir", "imgs", *cfg_args])
    for i in range(2):
        main(["extract-graph", f"scenes/{i}.txt", f"imgs/{i}.png", f"graph_{i}.npz", *cfg_args])
    main(["train-gcn", "graph_0.npz", "graph_1.npz", "--out", "gcn.npz", "--epochs", "300",
          "--lr", "1e-3", "--log", "gcn.jsonl", "--log-every", "100", *train_args])
    main(["evaluate", "gcn.npz", "graph_0.npz", "graph_1.npz", "--scenes-dir", "scenes",
          "--imgs-dir", "imgs", "--out-dir", "preds", *cfg_args])


def test_cli_full_pipeline_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    run_pipeline(cli.main, CPU_ARGS, ["--cpu"])
    monkeypatch.chdir(tmp_path / "jax")
    run_pipeline(jcli.main, CFG_ARGS, [])

    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    for i in range(2):
        assert (port / f"scenes/{i}.txt").read_bytes() == (jax_dir / f"scenes/{i}.txt").read_bytes()
        assert (port / f"imgs/{i}.png").exists()
        with np.load(port / f"graph_{i}.npz") as a, np.load(jax_dir / f"graph_{i}.npz") as b:
            assert sorted(a.files) == sorted(b.files) == ["labels", "light", "pixel", "w"]
            for k in a.files:
                assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
            assert a["w"].shape == (31, 30)
            np.testing.assert_allclose(a["labels"], b["labels"], rtol=1e-6)
    lines = [json.loads(line) for line in (port / "gcn.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == [100, 200, 300]
    assert lines[-1]["loss"] < lines[0]["loss"]
    assert (port / "preds/0_true.png").exists() and (port / "preds/1_pred.png").exists()
    with zipfile.ZipFile(port / "preds.zip") as zf:
        assert len(zf.namelist()) == 4


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Two generated scenes, their images and graphs at 24x24/4 spp."""
    d = tmp_path_factory.mktemp("cli")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        cli.main(["generate", "2", *CPU_ARGS])
        cli.main(["extract-graph", "scenes/0.txt", "imgs/0.png", "graph_0.npz", *CPU_ARGS])
    finally:
        os.chdir(cwd)
    return d


def test_recover_command(workdir, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    cli.main(["recover", "scenes/0.txt", "imgs/0.png", "--steps", "3", "--out", "kd.npy",
              "--render-out", "rec.png", "--log", "rec.jsonl", "--log-every", "1",
              "--checkpoint", "rec_ckpt.npz", "--checkpoint-every", "3", *CPU_ARGS])
    kd = np.load("kd.npy")
    assert kd.shape == (30, 3) and np.all((kd > 0) & (kd < 1))
    assert os.path.exists("rec.png") and os.path.exists("rec_ckpt.npz")
    with open("rec.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1, 2]
    assert "mean |Kd err| vs scene labels" in capsys.readouterr().out


def test_recover_batch_command(workdir, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    cli.main(["recover-batch", "2", "--steps", "3", "--out", "batch.npy", "--log", "b.jsonl",
              *CPU_ARGS])
    kd = np.load("batch.npy")
    assert kd.shape == (2, 30, 3) and np.all((kd > 0) & (kd < 1))
    out = capsys.readouterr().out
    assert "mean |Kd err| per scene" in out and "overall:" in out


def test_make_dataset_command(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    cli.main(["make-dataset", "2", "--out", "data.npz", *CPU_ARGS])
    with np.load("data.npz") as d, np.load("graph_0.npz") as g:
        assert d["w"].shape == (2, 31, 30) and d["pixel"].shape == (2, 31, 30, 3)
        assert d["light"].shape == (2, 31, 30, 3) and d["labels"].shape == (2, 30, 3)
        # Scene 0's graph is extract-graph's: same key, same configuration.
        np.testing.assert_array_equal(d["w"][0], g["w"])
    labels1 = load_scene(str(workdir / "scenes/1.txt"), asset_root=ASSET_ROOT).diffuse.numpy()
    np.testing.assert_array_equal(np.load(workdir / "data.npz")["labels"][1], labels1)


def test_graph_viz_command(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    cli.main(["graph-viz", "scenes/0.txt", "imgs/0.png", "viz", *CPU_ARGS])
    mesh = read_ply_counts("viz/mesh.ply")
    assert mesh == read_ply_counts(os.path.join(REPO, "artifacts/graphviz/mesh.ply"))
    with np.load("graph_0.npz") as g:
        n_edges = int((g["w"][:30] > 1e-3).sum())
    assert read_ply_counts("viz/lines.ply") == {"vertex": 30, "edge": n_edges}
    assert n_edges > 0


def test_evaluate_reads_a_jax_checkpoint(workdir, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    cli.main(["evaluate", os.path.join(REPO, "artifacts/exp100/gcn0_params.npz"), "graph_0.npz",
              "--out-dir", "preds0", *CPU_ARGS])
    with zipfile.ZipFile("preds0.zip") as zf:
        assert sorted(zf.namelist()) == ["preds0/0_pred.png", "preds0/0_true.png"]
    assert "PSNR(true, pred)" in capsys.readouterr().out


def test_render_profile_command(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    cli.main(["render", "scenes/0.txt", "r.png", "--profile", "trace", *CPU_ARGS])
    assert os.path.getsize("r.png") > 0
    traces = os.listdir("trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join("trace", traces[0])) as f:
        events = json.load(f)["traceEvents"]
    got = {e.get("name") for e in events}
    assert {"ipt.render.range", "ipt.launch.render_tile"} <= got  # the program's spans


ROOT = ["--asset-root", ASSET_ROOT]
NO_CARD_COMMANDS = {
    "render": ["render", "scenes/0.txt", "out.png", *ROOT],
    "generate": ["generate", "1", *ROOT],
    "extract-graph": ["extract-graph", "scenes/0.txt", "imgs/0.png", "out.npz", *ROOT],
    "graph-viz": ["graph-viz", "scenes/0.txt", "imgs/0.png", "viz_out", *ROOT],
    "train-gcn": ["train-gcn", "graph_0.npz", "--out", "out.npz", "--epochs", "1"],
    "recover": ["recover", "scenes/0.txt", "imgs/0.png", "--steps", "1", "--out", "out.npy",
                *ROOT],
    "make-dataset": ["make-dataset", "1", "--out", "out.npz", *ROOT],
    "recover-batch": ["recover-batch", "1", "--steps", "1", "--out", "out.npy", *ROOT],
    "evaluate": ["evaluate", "gcn.npz", "graph_0.npz", "--out-dir", "out_preds", *ROOT],
}


@pytest.mark.parametrize("name", sorted(NO_CARD_COMMANDS))
def test_no_card_and_no_cpu_flag_raises(workdir, tmp_path, monkeypatch, name):
    """No silent CPU run: the command raises before it writes anything."""
    for sub in ("scenes", "imgs"):
        (tmp_path / sub).symlink_to(workdir / sub)
    (tmp_path / "graph_0.npz").symlink_to(workdir / "graph_0.npz")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = sorted(os.listdir(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(NO_CARD_COMMANDS[name])
    assert sorted(os.listdir(tmp_path)) == before


def test_help_lists_every_command(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = capsys.readouterr().out
    assert all(name in out for name in NO_CARD_COMMANDS)


def test_coordinator_without_a_card_raises_before_joining(workdir, tmp_path, monkeypatch):
    """--coordinator with no card and no --cpu raises before it waits for
    the other processes, and writes nothing."""
    for sub in ("scenes", "imgs"):
        (tmp_path / sub).symlink_to(workdir / sub)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["recover", "scenes/0.txt", "imgs/0.png", "--steps", "1", "--out", "out.npy",
                  "--shard", "--coordinator", "127.0.0.1:1", "--num-processes", "2",
                  "--process-id", "0", *ROOT])
    assert sorted(os.listdir(tmp_path)) == ["imgs", "scenes"]


def test_two_process_recover_with_shard(tmp_path):
    from inverse_path_tracer_torch.utils.png import write_png

    write_png(str(tmp_path / "target.png"), np.full((16, 16, 3), 128, np.uint8))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m", "inverse_path_tracer_torch.cli", "recover",
               os.path.join(REPO, "scenes", "0.txt"), str(tmp_path / "target.png"),
               "--cpu", "--shard", "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", "2", "--process-id", str(pid), "--steps", "2", "--lr", "0.1",
               "--width", "16", "--height", "16", "--spp", "4", "--bounces", "2",
               "--tile", "64", "--out", str(tmp_path / f"out{pid}.npy")]
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=100)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "'process_count': 2" in out and "'global_devices': 2" in out
        assert "'backend': 'gloo'" in out
    a, b = np.load(tmp_path / "out0.npy"), np.load(tmp_path / "out1.npy")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (30, 3)


def test_shard_without_a_coordinator_is_one_rank(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    cli.main(["recover", "scenes/0.txt", "imgs/0.png", "--steps", "2", "--out", "kd_one.npy",
              "--shard", *CPU_ARGS])
    kd = np.load("kd_one.npy")
    assert kd.shape == (30, 3) and np.all((kd > 0) & (kd < 1))


def test_profiling_utils(tmp_path):
    # span: without a profiler one shared no-op context, no event recorded
    assert span("ipt.test.a") is span("ipt.test.b")
    with span("ipt.test.a"):
        torch.ones(8).sum()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("ipt.test.a"):
            torch.ones(8).sum()
    names = [e.name for e in prof.events()]
    assert names.count("ipt.test.a") == 1 and "ipt.test.b" not in names
    with profile_trace(None):  # the no-op path
        pass
    assert not os.listdir(tmp_path)
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0

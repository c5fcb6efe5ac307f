"""Rays split over the ranks of a process group (parallel/shard.py,
parallel/multihost.py) on the CPU: gloo, one fresh process per rank, each
with its own timeout and a free port.

  * Worlds of 1, 2 and 3 ranks render scene 0 bit-equal to render_samples
    (fused RNG) with equal counts, at the default tile_size (above a
    rank's share, where the JAX package warned) and at 64; world 3's shares
    end past the image (ragged).
  * World 2 in external mode (JAX's rays and uniforms) against the JAX
    package's render_samples_sharded on make_mesh(2) of its 8 virtual CPU
    devices: rtol 1e-4 / atol 1e-5 (tests/test_torch_forward.py's bars).
  * World 2's recovery step (SGD at lr 1, so the step is the gradient)
    against JAX's make_recover_step on the same rays: value rtol 1e-5,
    gradient rtol 2e-4 / atol 1e-7 (tests/test_torch_recover_batched.py's
    bars); against world 1: loss rtol 1e-6, gradient rtol 1e-5 / atol 1e-8
    (the JAX package's tests/test_sharding.py bars).
  * theta bit-identical on every rank after 3 Adam steps (worlds 2 and 3);
    recover_materials_batched(mesh=) over 2 scenes lowers the loss.
  * make_mesh without a process group, and init_distributed without a
    coordinator, are one rank; device=None without a card raises.

Run as a script, this file is one rank's worker (see _worker).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, load_scene  # noqa: E402
from inverse_path_tracer_torch.parallel.multihost import init_distributed  # noqa: E402
from inverse_path_tracer_torch.parallel.shard import (  # noqa: E402
    TileRNGInvariantWarning,
    make_mesh,
)

SCENE0 = os.path.join(REPO, "scenes", "0.txt")
SHAPE = dict(width=16, height=16, spp=4, max_bounces=4)
CFG = RenderConfig(**SHAPE)  # tile_size 2^20: above every rank's share
KEY, STEP_KEY = 5, 11
WORLDS = (1, 2, 3)
TIMEOUT = 100  # seconds, per worker process


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(args: dict) -> None:
    """One rank: join the gloo group, run every case, save the results."""
    torch.set_num_threads(1)
    from inverse_path_tracer_torch.models.recover import make_optimizer, recover_materials_batched
    from inverse_path_tracer_torch.parallel.shard import make_recover_step, render_samples_sharded

    info = init_distributed(f"127.0.0.1:{args['port']}", args["world"], args["rank"],
                            device="cpu")
    mesh = make_mesh(device="cpu")
    assert info["process_count"] == args["world"] and info["backend"] == "gloo"
    assert (mesh.rank, mesh.size) == (args["rank"], args["world"])
    scene = load_scene(SCENE0, asset_root=ASSET_ROOT)
    inp = dict(np.load(args["inputs"]))
    out = {}
    for tile in (CFG.tile_size, 64):
        vals, st = render_samples_sharded(scene.diffuse, scene, KEY, CFG.with_(tile_size=tile),
                                          mesh)
        out[f"vals_{tile}"] = vals.numpy()
        out[f"counts_{tile}"] = np.array([int(st.segments), int(st.shadow_rays)])
    target = torch.from_numpy(inp["target"])
    ext = dict(rays=(torch.from_numpy(inp["p"]), torch.from_numpy(inp["d"])),
               uniforms=torch.from_numpy(inp["u"]))
    ecfg = CFG.with_(rng="external", tile_size=128)
    if args["world"] <= 2:
        out["vals_ext"] = render_samples_sharded(scene.diffuse, scene, 0, ecfg, mesh,
                                                 **ext)[0].numpy()
        theta = torch.zeros_like(scene.diffuse, requires_grad=True)
        step = make_recover_step(scene, ecfg, mesh, torch.optim.SGD([theta], lr=1.0))
        out["loss_ext"] = np.float32(step(theta, 0, target, **ext))
        out["grad_ext"] = theta.grad.numpy()
    theta = torch.zeros_like(scene.diffuse, requires_grad=True)
    step = make_recover_step(scene, CFG, mesh, make_optimizer(theta, 0.1))
    out["adam_losses"] = np.array([step(theta, STEP_KEY + i, target) for i in range(3)])
    out["adam_theta"] = theta.detach().numpy()
    if args["world"] == 2:
        targets = torch.from_numpy(inp["targets2"])
        mats, losses = recover_materials_batched(scene, targets, CFG, steps=6, lr=0.1, key=3,
                                                 mesh=mesh)
        out["batch_mats"], out["batch_losses"] = mats.numpy(), np.array(losses)
    np.savez(args["out"], **out)


def _launch(world: int, inputs: str, tmp) -> list:
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        args = dict(port=port, world=world, rank=rank, inputs=inputs,
                    out=str(tmp / f"w{world}_r{rank}.npz"))
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                        json.dumps(args)], env=env, cwd=str(tmp),
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                      args["out"]))
    return procs


@pytest.fixture(scope="module")
def scene():
    return load_scene(SCENE0, asset_root=ASSET_ROOT)


@pytest.fixture(scope="module")
def jax_case(scene):
    """JAX's rays and uniforms of scene 0 at SHAPE (tile 128), its sharded
    render and sharded SGD step on make_mesh(2), and the targets."""
    import jax
    import jax.numpy as jnp
    import optax

    import inverse_path_tracer_tpu as jipt
    from inverse_path_tracer_tpu.parallel import shard as jshard
    from test_torch_forward import jax_rays_and_uniforms

    from inverse_path_tracer_torch import render_image

    js = jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    jcfg = jipt.RenderConfig(tile_size=128, backend="xla", grad_mode="ad", **SHAPE)
    key = jax.random.PRNGKey(7)
    p, d, u = jax_rays_and_uniforms(js, jcfg, key)
    target = render_image(scene.diffuse * 0.7, scene, 2, CFG, device="cpu")
    jmesh = jshard.make_mesh(2)
    jvals, jstats = jshard.render_samples_sharded(js.diffuse, js, key, jcfg, jmesh)
    opt = optax.sgd(1.0)
    theta0 = jnp.zeros_like(js.diffuse)
    theta1, _, jloss = jshard.make_recover_step(js, jcfg, jmesh, opt)(
        theta0, opt.init(theta0), key, jnp.asarray(target.numpy()))
    targets2 = torch.stack([render_image(scene.diffuse * f, scene, 4, CFG, device="cpu")
                            for f in (1.0, 0.4)])
    return dict(p=p.numpy(), d=d.numpy(), u=u.numpy(), target=target.numpy(),
                targets2=targets2.numpy(), jvals=np.asarray(jvals),
                jsegments=int(jstats.segments), jloss=float(jloss),
                jgrad=-np.asarray(theta1))


@pytest.fixture(scope="module")
def worlds(jax_case, tmp_path_factory):
    """{world: [each rank's results]}: every world's ranks started at once."""
    tmp = tmp_path_factory.mktemp("shard")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **{k: jax_case[k] for k in ("p", "d", "u", "target", "targets2")})
    launched = {w: _launch(w, inputs, tmp) for w in WORLDS}
    results = {}
    for w, procs in launched.items():
        ranks = []
        for rank, (proc, out) in enumerate(procs):
            try:
                log = proc.communicate(timeout=TIMEOUT)[0].decode()
            except subprocess.TimeoutExpired:
                for p, _ in procs:
                    p.kill()
                raise AssertionError(f"world {w} rank {rank} did not finish in {TIMEOUT} s")
            assert proc.returncode == 0, f"world {w} rank {rank} failed:\n{log}"
            ranks.append(dict(np.load(out)))
        results[w] = ranks
    return results


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tile", [CFG.tile_size, 64])
def test_sharded_render_bit_equal_to_one_rank(scene, worlds, world, tile):
    from inverse_path_tracer_torch import render_samples

    want, st = render_samples(scene.diffuse, scene, KEY, CFG.with_(tile_size=tile),
                              device="cpu")
    for r in worlds[world]:
        np.testing.assert_array_equal(r[f"vals_{tile}"], want.numpy())
        assert r[f"counts_{tile}"].tolist() == [int(st.segments), int(st.shadow_rays)]


def test_external_world2_matches_jax_sharded(worlds, jax_case):
    for r in worlds[2]:
        np.testing.assert_allclose(r["vals_ext"], jax_case["jvals"], rtol=1e-4, atol=1e-5)
    # the ranks' external renders are one rank's, bit for bit
    np.testing.assert_array_equal(worlds[2][0]["vals_ext"], worlds[1][0]["vals_ext"])


def test_sharded_step_matches_jax_and_one_rank(worlds, jax_case):
    one = worlds[1][0]
    for r in worlds[2]:
        np.testing.assert_allclose(float(r["loss_ext"]), jax_case["jloss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_ext"], jax_case["jgrad"], rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(float(r["loss_ext"]), float(one["loss_ext"]), rtol=1e-6)
        np.testing.assert_allclose(r["grad_ext"], one["grad_ext"], rtol=1e-5, atol=1e-8)
    assert np.abs(one["grad_ext"]).max() > 0


@pytest.mark.parametrize("world", [2, 3])
def test_theta_bit_identical_across_ranks(worlds, world):
    ranks = worlds[world]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["adam_theta"], ranks[0]["adam_theta"])
        np.testing.assert_array_equal(r["adam_losses"], ranks[0]["adam_losses"])
    one = worlds[1][0]
    np.testing.assert_allclose(ranks[0]["adam_theta"], one["adam_theta"], rtol=1e-4, atol=1e-6)
    assert np.abs(ranks[0]["adam_theta"]).max() > 0


def test_batched_recovery_over_a_mesh_lowers_the_loss(worlds):
    a, b = worlds[2]
    np.testing.assert_array_equal(a["batch_mats"], b["batch_mats"])
    losses = a["batch_losses"]
    assert a["batch_mats"].shape == (2, 30, 3) and losses[-1] < losses[0]


def test_one_rank_without_a_process_group(scene):
    assert init_distributed()["process_count"] == 1
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_gather(x) is x and mesh.all_reduce(x) is x
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")


def test_device_none_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


def test_tile_rng_warning_is_never_raised(scene, worlds):
    """The JAX package warned where tile_size exceeds a device's share; the
    port's render is the same at any tile_size (the worlds above use
    2^20 against shares of 344-1024 samples), so it keeps the class only."""
    assert issubclass(TileRNGInvariantWarning, UserWarning)
    for w in WORLDS:
        np.testing.assert_array_equal(worlds[w][0][f"vals_{CFG.tile_size}"],
                                      worlds[w][0]["vals_64"])


if __name__ == "__main__":
    _worker(json.loads(sys.argv[1]))

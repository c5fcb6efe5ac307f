"""render_tile_plain (the plain version of the port's CUDA megakernel)
against the JAX Pallas kernel render_tile_pallas, run in interpret mode with
fast_recip=False, on the same rays, alive mask, sample indices, uniforms or
key words, and scene (carried across with convert.py).

Tolerance: radiance rtol 1e-4 / atol 1e-5, segment and shadow-ray counts
equal per lane (the JAX package's own Pallas-vs-XLA contract on flat
scenes).  Sizes stay at 8x8 pixels x 4 spp and 5 bounces, since interpret
mode is slow.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.ops.pallas.render_kernel import render_tile_pallas
from inverse_path_tracer_tpu.render.forward import _pallas_keys

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, scene_from_numpy
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    pack_tables,
    render_tile,
    render_tile_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
N = 8 * 8 * 4
BOUNCES = 5
RTOL, ATOL = 1e-4, 1e-5


def jax_scene(kind, tmp_path):
    if kind == "cornell":
        return jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)
    from inverse_path_tracer_tpu.scene.build import build_scene
    from inverse_path_tracer_tpu.scene.dsl import ObjectParams

    mtl = tmp_path / "spec.mtl"
    mtl.write_text("newmtl cube\nKd 0.5 0.3 0.2\nKs 0.4 0.4 0.4\nNs 16\n")
    box = ObjectParams(pos=(0, 0, 4), scl=(2, 2, 2),
                       obj_file="CornellBox/CornellBox-Empty-CO.obj",
                       mtl_file="CornellBox/CornellBox-Empty-CO.mtl")
    cube = ObjectParams(pos=(0, -1.5, 4), obj_file="shapes/cube.obj", mtl_file=str(mtl))
    return build_scene([box, cube], asset_root=ASSET_ROOT)


def inputs(seed):
    """Camera-like rays from the origin into the box, a few dead lanes."""
    g = np.random.default_rng(seed)
    d = np.stack([g.uniform(-1, 1, N), g.uniform(-1, 1, N), np.ones(N)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    alive = (g.random((1, N)) > 0.05).astype(np.float32)
    orig = (np.arange(N, dtype=np.int32) * 3 + 1000)[None, :]
    u = g.random((BOUNCES * 8, N)).astype(np.float32)
    return np.zeros((3, N), np.float32), d, alive, orig, u


CASES = [
    ("cornell", "external", True),
    ("cornell", "external", False),
    ("cornell", "fused", True),
    ("cornell", "fused", False),
    ("specular", "external", True),
    ("specular", "fused", True),
]


@pytest.mark.parametrize("kind,mode,quirks", CASES)
def test_plain_matches_pallas_interpret(kind, mode, quirks, tmp_path):
    js = jax_scene(kind, tmp_path)
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})
    if kind == "specular":
        assert ts.specular_idx.numel() > 0
    jcfg = jipt.RenderConfig(max_bounces=BOUNCES, reference_quirks=quirks, fast_recip=False)
    tcfg = RenderConfig(max_bounces=BOUNCES, reference_quirks=quirks)
    p, d, alive, orig, u = inputs(seed=len(kind) * 10 + quirks)
    fused = mode == "fused"
    want_rad, want_st = render_tile_pallas(
        js.diffuse, js, jcfg, jnp.asarray(p), jnp.asarray(d), jnp.asarray(alive),
        None if fused else jnp.asarray(u), block=128, interpret=True,
        orig=jnp.asarray(orig), keys=_pallas_keys(jax.random.PRNGKey(13)) if fused else None,
    )
    got_rad, got_st = render_tile_plain(
        ts.diffuse, ts, tcfg, *map(torch.from_numpy, (p, d, alive)),
        uniforms=None if fused else torch.from_numpy(u),
        orig=torch.from_numpy(orig), keys=rng.key_words(13) if fused else None,
    )
    np.testing.assert_allclose(got_rad.numpy(), np.asarray(want_rad), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    assert float(got_st[0].sum()) > N  # the paths do bounce


def test_render_tile_on_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    ts = scene_from_numpy({k: np.asarray(v) for k, v in
                           jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)._asdict().items()})
    cfg = RenderConfig(max_bounces=BOUNCES)
    p, d, alive, orig, u = map(torch.from_numpy, inputs(seed=3))
    before = render_tile.launches
    a = render_tile(ts.diffuse, ts, cfg, p, d, alive, uniforms=u, orig=orig)
    b = render_tile_plain(ts.diffuse, ts, cfg, p, d, alive, uniforms=u, orig=orig)
    assert render_tile.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_render_tile_validates_inputs():
    ts = scene_from_numpy({k: np.asarray(v) for k, v in
                           jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)._asdict().items()})
    cfg = RenderConfig(max_bounces=BOUNCES)
    p, d, alive, orig, u = map(torch.from_numpy, inputs(seed=4))
    with pytest.raises(ValueError, match="exactly one"):
        render_tile(ts.diffuse, ts, cfg, p, d, alive, uniforms=u, orig=orig, keys=(0, 1))
    with pytest.raises(ValueError, match="uniforms"):
        render_tile(ts.diffuse, ts, cfg, p, d, alive, uniforms=u[:8], orig=orig)
    with pytest.raises(ValueError, match="orig"):
        render_tile(ts.diffuse, ts, cfg, p, d, alive, uniforms=u, orig=orig.long())


def test_pack_tables_layout():
    ts = scene_from_numpy({k: np.asarray(v) for k, v in
                           jipt.load_scene(SCENE0, asset_root=ASSET_ROOT)._asdict().items()})
    tabs = pack_tables(ts, ts.diffuse)
    assert tabs.planes.shape == (30, 16) and tabs.table.shape == (30, 16)
    assert tabs.etab.shape == (2, 17) and tabs.vtab is None and tabs.no_spec
    torch.testing.assert_close(tabs.table[:, 10:13], ts.diffuse, rtol=0, atol=0)
    torch.testing.assert_close(tabs.table[:, 7:10], ts.face_normal, rtol=0, atol=0)
    assert tabs.etab[:, 15].tolist() == [16.0, 17.0]
    # Plane row 0 is (n, -c.n): the centroid lies on its plane.
    plane_at_center = (tabs.planes[:, 0:3] * ts.center).sum(-1) + tabs.planes[:, 3]
    assert plane_at_center.abs().max() < 1e-5


def test_pack_tables_emitter_free_and_vertex_normals(tmp_path):
    from inverse_path_tracer_torch import build_scene
    from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
    from inverse_path_tracer_torch.scene.dsl import ObjectParams

    obj = tmp_path / "sphere.obj"
    obj.write_text(sphere_obj_text(rings=4, segments=6))
    scene = build_scene([ObjectParams(obj_file=str(obj), mtl_file="*Kd 0.5 0.5 0.5*")])
    assert scene.n_emissive == 0
    tabs = pack_tables(scene, scene.diffuse)
    assert tabs.etab.shape == (0, 27) and tabs.cdf.shape == (0,)
    assert tabs.vtab.shape == (scene.n_tri, 20)
    torch.testing.assert_close(tabs.vtab[:, 9:18], scene.vertex_normals.flatten(1), rtol=0, atol=0)

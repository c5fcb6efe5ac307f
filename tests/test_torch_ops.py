"""The port's ops against the JAX package's on the same seeded numpy inputs.

Tolerances: rtol 1e-5 / atol 1e-6 for float results (both compute in
float32; sums and transcendental functions may round differently in the
last bit), exact equality for hit flags, triangle indices, emitter picks,
uint8 pixels and every RNG bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu.ops.bsdf as jbsdf
import inverse_path_tracer_tpu.ops.intersect as jint
import inverse_path_tracer_tpu.ops.sampling as jsam
import inverse_path_tracer_tpu.ops.tonemap as jtone
import inverse_path_tracer_tpu.scene.build as jbuild
from inverse_path_tracer_tpu.ops.pallas.render_kernel import (
    _fmix32,
    _make_uniform_stream,
    _unit_from_bits_i32,
)
from inverse_path_tracer_tpu.render.forward import _pallas_keys

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, load_scene
from inverse_path_tracer_torch.assets.make_fixture import sphere_obj_text
from inverse_path_tracer_torch.ops import bsdf, intersect, rng, sampling, tonemap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE0 = os.path.join(REPO, "scenes", "0.txt")
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def scenes():
    return (jbuild.load_scene(SCENE0, asset_root=ASSET_ROOT),
            load_scene(SCENE0, asset_root=ASSET_ROOT))


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def unit_vectors(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_tonemap_matches_jax():
    g = np.random.default_rng(0)
    samples = (g.exponential(size=(6 * 5 * 4, 3)) * 3).astype(np.float32)
    img = tonemap.tonemap_mean(t(samples), 4)
    close(img, jtone.tonemap_mean(jnp.asarray(samples), 4))
    np.testing.assert_array_equal(
        tonemap.tonemap_to_uint8(img).numpy(),
        np.asarray(jtone.tonemap_to_uint8(jnp.asarray(img.numpy()))),
    )


def test_bsdf_matches_jax():
    g = np.random.default_rng(1)
    n = 256
    kd = g.random((n, 3)).astype(np.float32)
    spec = (g.random((n, 3)) * (g.random((n, 1)) < 0.5)).astype(np.float32)
    shin = g.choice([0.0, 1.0, 16.0, 3.5], size=n).astype(np.float32)
    nrm, w, wi = unit_vectors(g, n), unit_vectors(g, n), unit_vectors(g, n)
    close(bsdf.specular_coeff(t(shin), t(nrm), t(w), t(wi)),
          jbsdf.specular_coeff(*map(jnp.asarray, (shin, nrm, w, wi))))
    for direct in (True, False):
        close(bsdf.bsdf_from_values(*map(t, (kd, spec, shin, nrm, w, wi)), direct),
              jbsdf.bsdf_from_values(*map(jnp.asarray, (kd, spec, shin, nrm, w, wi)), direct))


def test_bsdf_diagonal_matches_jax(scenes):
    js, ts = scenes
    g = np.random.default_rng(2)
    tri = g.integers(0, 30, size=64)
    nrm, w, wi = unit_vectors(g, 64), unit_vectors(g, 64), unit_vectors(g, 64)
    close(bsdf.bsdf_diagonal(ts.diffuse, ts, t(tri), t(nrm), t(w), t(wi), False),
          jbsdf.bsdf_diagonal(js.diffuse, js, jnp.asarray(tri), *map(jnp.asarray, (nrm, w, wi)), False))


def test_rotate_z_to_matches_jax_including_minus_z():
    g = np.random.default_rng(3)
    nrm = unit_vectors(g, 128)
    nrm[:4] = [[0, 0, -1], [0, 0, 1], [1, 0, 0], [0, -1, 0]]
    vec = unit_vectors(g, 128)
    got = sampling.rotate_z_to(t(nrm), t(vec))
    close(got, jsam.rotate_z_to(jnp.asarray(nrm), jnp.asarray(vec)))
    # n.z == -1: the reference's R = -I branch.
    np.testing.assert_array_equal(got[0].numpy(), -vec[0])


def test_sample_next_dir_matches_jax():
    g = np.random.default_rng(4)
    n = 256
    nrm = unit_vectors(g, n)
    nrm[0] = (0, 0, -1)
    is_spec = g.random(n) < 0.5
    shin = g.choice([1.0, 8.0, 32.0], size=n).astype(np.float32)
    u1, u2 = g.random(n).astype(np.float32), g.random(n).astype(np.float32)
    want_d, want_pdf = jsam.sample_next_dir(*map(jnp.asarray, (nrm, is_spec, shin, u1, u2)))
    got_d, got_pdf = sampling.sample_next_dir(*map(t, (nrm, is_spec, shin, u1, u2)))
    close(got_d, want_d)
    close(got_pdf, want_pdf)
    # The scene-wide diffuse form (is_specular=None) is the same function.
    want_d, want_pdf = jsam.sample_next_dir(
        jnp.asarray(nrm), jnp.zeros(n, bool), jnp.asarray(shin), jnp.asarray(u1), jnp.asarray(u2))
    got_d, got_pdf = sampling.sample_next_dir(t(nrm), None, t(shin), t(u1), t(u2))
    close(got_d, want_d)
    close(got_pdf, want_pdf)


def test_pick_emissive_and_point_match_jax(scenes):
    js, ts = scenes
    g = np.random.default_rng(5)
    u = g.random(200).astype(np.float32)
    u[:3] = [0.0, 0.5, 1.0]  # 1.0 may exceed cdf[-1]: clamps to the last emitter
    j_tri, j_p = jsam.pick_emissive(js, jnp.asarray(u))
    t_tri, t_p = sampling.pick_emissive(ts, t(u))
    np.testing.assert_array_equal(t_tri.numpy(), np.asarray(j_tri))
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_p))
    r1, r2 = g.random(200).astype(np.float32), g.random(200).astype(np.float32)
    close(sampling.sample_emissive_point(ts, t_tri, t(r1), t(r2)),
          jsam.sample_emissive_point(js, j_tri, jnp.asarray(r1), jnp.asarray(r2)))


def rays_in_box(seed, n):
    g = np.random.default_rng(seed)
    p = (g.uniform(-1.8, 1.8, size=(n, 3)) + [0, 0, 4]).astype(np.float32)
    return p, unit_vectors(g, n)


@pytest.mark.parametrize("name", ["brute", "fast"])
def test_intersect_matches_jax(scenes, name):
    js, ts = scenes
    p, d = rays_in_box(6, 512)
    d[:2] = [[0, 0, 1], [0, -1, 0]]
    p[:2] = [[0, 0, 0], [0, 0, 4]]
    want = getattr(jint, f"intersect_{name}")(js, jnp.asarray(p), jnp.asarray(d))
    got = getattr(intersect, f"intersect_{name}")(ts, t(p), t(d))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    close(got.t[got.hit], np.asarray(want.t)[np.asarray(want.hit)])
    close(got.point, want.point)
    assert got.hit.float().mean() > 0.5  # the box is open only at the front
    np.testing.assert_allclose(got.t[:2].numpy(), [6.0, 1.0], rtol=1e-6)


def test_intersect_ties_go_to_lowest_index(scenes):
    """Two copies of the scene: every hit must land in the first copy."""
    _, ts = scenes
    planes = intersect.plane_rows(ts)
    doubled = torch.cat([planes, planes], dim=0)
    p, d = rays_in_box(7, 256)
    one = intersect.intersect_planes(planes, t(p), t(d))
    two = intersect.intersect_planes(doubled, t(p), t(d))
    np.testing.assert_array_equal(two.tri.numpy(), one.tri.numpy())
    np.testing.assert_array_equal(two.t.numpy(), one.t.numpy())


def test_intersect_rejects_below_epsilon_and_misses(scenes):
    _, ts = scenes
    got = intersect.intersect_fast(ts, t([[0.0, 0.0, 5.995], [0.0, 0.0, 0.0]]),
                                   t([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]))
    assert not got.hit.any()
    assert torch.isinf(got.t).all() and (got.tri == 0).all()


def test_smooth_normal_matches_jax(tmp_path):
    obj = tmp_path / "sphere.obj"
    obj.write_text(sphere_obj_text(rings=6, segments=8))
    from inverse_path_tracer_tpu.scene.dsl import ObjectParams as JP
    from inverse_path_tracer_torch.scene.build import build_scene
    from inverse_path_tracer_torch.scene.dsl import ObjectParams

    kw = dict(pos=(0, 0, 4), obj_file=str(obj), mtl_file="*Kd 1 1 1*")
    js, ts = jbuild.build_scene([JP(**kw)]), build_scene([ObjectParams(**kw)])
    g = np.random.default_rng(8)
    tri = g.integers(0, ts.n_tri, size=128)
    bary = g.dirichlet([1, 1, 1], size=128).astype(np.float32)
    point = np.einsum("rc,rcx->rx", bary, ts.vertices.numpy()[tri]).astype(np.float32)
    close(intersect.smooth_normal(ts, t(tri), t(point)),
          jint.smooth_normal(js, jnp.asarray(tri), jnp.asarray(point)))


# --- counter-hash RNG: bit equality -------------------------------------

def edge_int32(seed, n=4096):
    g = np.random.default_rng(seed)
    x = g.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)
    x[:6] = [0, -1, -(2**31), 2**31 - 1, -1640531527, 1 << 30]  # top bit set and clear
    return x


def test_fmix32_and_unit_bit_equal_to_jax():
    x = edge_int32(9)
    want = np.asarray(_fmix32(jnp.asarray(x))).view(np.uint32)
    got = rng.fmix32(torch.from_numpy(x.astype(np.int64) & rng.MASK32)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    want_u = np.asarray(_unit_from_bits_i32(jnp.asarray(x)))
    got_u = rng.unit_from_bits(torch.from_numpy(x.astype(np.int64) & rng.MASK32)).numpy()
    np.testing.assert_array_equal(got_u.view(np.uint32), want_u.view(np.uint32))
    assert got_u.min() >= 0.0 and got_u.max() < 1.0


@pytest.mark.parametrize("words", [None, (0x9E3779B9, 0xDEADBEEF)])
def test_fused_draw_bit_equal_to_jax(words):
    """The port's draw against the Pallas kernel's fused uniform stream, for
    the key words of jax.random.PRNGKey(7) and for words with the top bit
    set."""
    if words is None:
        keys = rng.key_words(7)
        jkeys = _pallas_keys(jax.random.PRNGKey(7))
        np.testing.assert_array_equal(np.asarray(jkeys).view(np.uint32), keys)
    else:
        keys = words
        jkeys = jnp.asarray(np.asarray(words, np.uint32).view(np.int32))
    orig = np.arange(0, 3000, 7, dtype=np.int32)
    orig[-1] = 2**31 - 1
    draw = _make_uniform_stream(True, jkeys, jnp.asarray(orig)[None, :], orig.size)
    h = rng.hash_orig(keys, torch.from_numpy(orig))
    for b in (0, 1, 15):
        want = np.asarray(draw(b, b))
        got = rng.draw(keys, h, b).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_key_words():
    assert rng.key_words(0) == (0, 0)
    assert rng.key_words(5) == (0, 5)
    assert rng.key_words((3 << 32) | 9) == (3, 9)
    with pytest.raises(ValueError):
        rng.key_words(-1)

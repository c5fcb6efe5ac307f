"""The plain versions of the gradient kernels against the JAX package's
Pallas kernels, run in interpret mode with fast_recip=False, on the same
rays, alive mask, sample indices, uniforms or key words, cotangent and
scene (inputs made with numpy from a seed):

  * grad_tile_plain (B2) against grad_tile_pallas: rtol 2e-4 / atol 1e-7
    (tests/test_pallas.py's fused-backward tolerance);
  * render_tile_rec_plain's records (B3) against render_tile_pallas_rec's:
    rtol 1e-4 / atol 1e-5 (the forward's tolerance), tri, hit and esc
    equal.  The Pallas kernel leaves the stale throughput and triangle of
    the last live bounce in the slots after a ray's path ends, which the
    recursion never reads (hit = esc = 0 there); the port zeroes those
    slots, so they are compared as zero;
  * reverse_tile_plain (B4) against reverse_tile_pallas on the same Pallas
    records: rtol 1e-5.

The cases are tests/test_torch_render_kernel.py's, at 8x8 pixels x 4 spp
and 5 bounces, since interpret mode is slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inverse_path_tracer_tpu as jipt
from inverse_path_tracer_tpu.ops.pallas.render_kernel import (
    grad_tile_pallas,
    render_tile_pallas_rec,
    reverse_tile_pallas,
)
from inverse_path_tracer_tpu.render.forward import _pallas_keys

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import RenderConfig, scene_from_numpy
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    grad_tile,
    grad_tile_plain,
    render_tile_rec,
    render_tile_rec_plain,
    reverse_tile,
    reverse_tile_plain,
)
from inverse_path_tracer_torch.render.diff import REC_ROWS, BounceRecords
from test_torch_render_kernel import BOUNCES, CASES, N, inputs, jax_scene

BLOCK = 128


def setup(kind, mode, quirks, tmp_path):
    js = jax_scene(kind, tmp_path)
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})
    jcfg = jipt.RenderConfig(max_bounces=BOUNCES, reference_quirks=quirks, fast_recip=False)
    tcfg = RenderConfig(max_bounces=BOUNCES, reference_quirks=quirks)
    p, d, alive, orig, u = inputs(seed=len(kind) * 10 + quirks)
    g = np.random.default_rng(len(mode) + quirks).random((3, N)).astype(np.float32)
    fused = mode == "fused"
    jargs = dict(orig=jnp.asarray(orig),
                 keys=_pallas_keys(jax.random.PRNGKey(13)) if fused else None)
    targs = dict(orig=torch.from_numpy(orig), keys=rng.key_words(13) if fused else None)
    jrays = (js.diffuse, js, jcfg, jnp.asarray(p), jnp.asarray(d), jnp.asarray(alive))
    trays = (ts.diffuse, ts, tcfg, *map(torch.from_numpy, (p, d, alive)))
    ju = None if fused else jnp.asarray(u)
    tu = None if fused else torch.from_numpy(u)
    return js, ts, jcfg, tcfg, jrays, trays, ju, tu, jargs, targs, g


@pytest.mark.parametrize("kind,mode,quirks", CASES)
def test_grad_tile_plain_matches_pallas(kind, mode, quirks, tmp_path):
    js, ts, jcfg, tcfg, jrays, trays, ju, tu, jargs, targs, g = setup(kind, mode, quirks,
                                                                       tmp_path)
    want = grad_tile_pallas(*jrays, jnp.asarray(g), ju, block=BLOCK, interpret=True, **jargs)
    got = grad_tile_plain(*trays, torch.from_numpy(g), tu, **targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-7)
    assert np.count_nonzero(np.asarray(want)) > 20
    # On CPU tensors the wrapper is the plain version and launches nothing.
    before = grad_tile.launches
    again = grad_tile(*trays, torch.from_numpy(g), tu, **targs)
    assert grad_tile.launches == before and torch.equal(again, got)


@pytest.mark.parametrize("kind,mode,quirks", CASES)
def test_records_and_reverse_match_pallas(kind, mode, quirks, tmp_path):
    js, ts, jcfg, tcfg, jrays, trays, ju, tu, jargs, targs, g = setup(kind, mode, quirks,
                                                                       tmp_path)
    j_rad, j_st, j_rec = render_tile_pallas_rec(*jrays, ju, block=BLOCK, interpret=True,
                                                **jargs)
    rad, st, rec = render_tile_rec_plain(*trays, tu, **targs)
    np.testing.assert_allclose(rad.numpy(), np.asarray(j_rad), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(st.numpy(), np.asarray(j_st))
    assert rec.shape == (BOUNCES * REC_ROWS, N)

    j_rec = np.asarray(j_rec).reshape(BOUNCES, REC_ROWS, N)
    live = (j_rec[:, 14] + j_rec[:, 15]) > 0  # hit or escape: the bounce ran
    want = np.where(live[:, None, :], j_rec, 0.0)
    got = rec.numpy().reshape(BOUNCES, REC_ROWS, N)
    np.testing.assert_array_equal(got[:, 13:16], want[:, 13:16])  # tri, hit, esc
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert live.sum() > N and (got[:, 15] > 0).any() and (got[:, 14] > 0).any()
    recs = BounceRecords.from_rows(rec)
    assert recs.tri.dtype == torch.int64 and recs.f.shape == (BOUNCES, N, 3)

    # B4 on the same (Pallas) records.
    j_grad = reverse_tile_pallas(js.vertices.shape[0], jcfg, jnp.asarray(j_rec.reshape(-1, N)),
                                 jnp.asarray(g), block=BLOCK, interpret=True)
    t_grad = reverse_tile_plain(ts.n_tri, tcfg, torch.from_numpy(j_rec.reshape(-1, N).copy()),
                                torch.from_numpy(g))
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-9)
    # ... and on the port's own records it is B2's plain version.
    torch.testing.assert_close(reverse_tile_plain(ts.n_tri, tcfg, rec, torch.from_numpy(g)),
                               grad_tile_plain(*trays, torch.from_numpy(g), tu, **targs),
                               rtol=0, atol=0)

    before = (render_tile_rec.launches, reverse_tile.launches)
    rad2, _, rec2 = render_tile_rec(*trays, tu, **targs)
    reverse_tile(ts.n_tri, tcfg, rec2, torch.from_numpy(g))
    assert (render_tile_rec.launches, reverse_tile.launches) == before
    assert torch.equal(rec2, rec) and torch.equal(rad2, rad)


def test_gradient_wrappers_validate_inputs(tmp_path):
    js, ts, jcfg, tcfg, jrays, trays, ju, tu, jargs, targs, g = setup("cornell", "external",
                                                                       True, tmp_path)
    with pytest.raises(ValueError, match="g:"):
        grad_tile(*trays, torch.zeros(3, N - 1), tu, **targs)
    with pytest.raises(ValueError, match="rec:"):
        reverse_tile(ts.n_tri, tcfg, torch.zeros(REC_ROWS, N), torch.zeros(3, N))

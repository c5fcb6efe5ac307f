"""The plain reference against the program at a tiny size on the CPU:
the scene arrays, the keys, a render sample by sample with its counts,
three steps of batched recovery, and an extraction."""

import pytest
import torch

from benchmark.lib import manifest, program
from benchmark.reference import rng as rr
from benchmark.reference import tracer

W = H = 8
SPP, BOUNCES = 4, 6


def _scenes(config, gen_dir):
    cfg = manifest.read_json(f"{manifest.BENCH_DIR}/configs/{config}.json")
    return cfg, program.build_scene(cfg, gen_dir), program.reference_scene(cfg, gen_dir)


@pytest.mark.parametrize("config", ["cornell30", "sphere1298"])
def test_scene_arrays_equal(config, gen_dir):
    from inverse_path_tracer_torch.ops.intersect import plane_rows

    cfg, ps, rs = _scenes(config, gen_dir)
    assert ps.n_tri == cfg["triangles"] and ps.n_emissive == cfg["emissive"]
    pairs = {"v": ps.vertices, "fn": ps.face_normal, "area": ps.area, "emission": ps.emission,
             "e_idx": ps.emissive_idx, "e_p": ps.emissive_p, "e_cdf": ps.emissive_cdf,
             "m33": ps.cam_m33, "planes": plane_rows(ps)}
    if ps.has_vertex_normals:
        pairs["vn"] = ps.vertex_normals
    else:
        assert rs["vn"] is None
    for k, v in pairs.items():
        assert torch.equal(rs[k], v), k


def test_keys_equal():
    from inverse_path_tracer_torch.ops import rng as prng

    for key, data in [(0, 0), (2**31 + 5, 7), (2**63 + 11, 0x43414D)]:
        assert rr.fold_in(key, data) == prng.fold_in(key, data)
    idx = torch.arange(1000) * 7919
    h = rr.sample_hash(123456789, idx)
    assert torch.equal(rr.uniforms(123456789, h, 3, range(8)),
                       prng.draw(prng.key_words(123456789), prng.hash_orig(
                           prng.key_words(123456789), idx), 3))


@pytest.mark.parametrize("config", ["cornell30", "sphere1298"])
def test_render_sample_by_sample(config, gen_dir):
    import inverse_path_tracer_torch as ipt

    _, ps, rs = _scenes(config, gen_dir)
    cfg = ipt.RenderConfig(width=W, height=H, spp=SPP, max_bounces=BOUNCES)
    key = 2**40 + 3
    vals, st = ipt.render_samples(ps.diffuse, ps, key, cfg, device="cpu")
    rad, segs, sh = tracer.render(tracer.on(rs, "cpu", torch.float32), ps.diffuse, key,
                                  torch.arange(cfg.n_samples), W, H, SPP, BOUNCES, 0.9)
    assert torch.equal(rad, vals)
    assert int(segs.sum()) == int(st.segments) and int(sh.sum()) == int(st.shadow_rays)


def test_recovery_steps(gen_dir):
    import inverse_path_tracer_torch as ipt
    from inverse_path_tracer_torch.models.recover import batched_step, make_optimizer

    _, ps, rs = _scenes("cornell30", gen_dir)
    cfg = ipt.RenderConfig(width=W, height=H, spp=SPP, max_bounces=BOUNCES)
    targets = torch.rand((3, H, W, 3), generator=torch.Generator().manual_seed(1))
    keys = [[rr.fold_in(rr.fold_in(99, i), j) for j in range(3)] for i in range(3)]
    theta = torch.zeros((3, ps.n_tri, 3), requires_grad=True)
    opt = make_optimizer(theta, 0.1)
    losses = []
    for i in range(3):
        losses.append(batched_step(theta, opt, ps, keys[i], cfg, targets, device="cpu"))
        if i == 0:
            g1 = opt.state[theta]["exp_avg"] / 0.1
    steps, th = tracer.recover_steps(tracer.on(rs, "cpu", torch.float32), targets, keys, 0.1,
                                     W, H, SPP, BOUNCES, 0.9, pixels_per_chunk=16)
    for a, s in zip(losses, steps):
        torch.testing.assert_close(a.double(), s["losses"], rtol=1e-6, atol=0)
    torch.testing.assert_close(g1, steps[0]["grads"], rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(theta.detach(), th, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("config", ["cornell30", "sphere1298"])
def test_extraction(config, gen_dir):
    import inverse_path_tracer_torch as ipt

    _, ps, rs = _scenes(config, gen_dir)
    cfg = ipt.RenderConfig(width=W, height=H, spp=SPP, max_bounces=BOUNCES)
    image = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(2))
    got = ipt.extract_graph(ps, image, 77, cfg, device="cpu")
    (w, pixel, light), n, hits = tracer.extract(tracer.on(rs, "cpu", torch.float32),
                                             image.reshape(-1, 3), 77, W, H, SPP, BOUNCES, 0.9,
                                             samples_per_chunk=64)
    _, st = ipt.trace_transport_range(ps, image, 77, cfg, 0, cfg.n_samples, device="cpu")
    assert hits == int(st.shadow_rays) and int(n.sum()) > hits
    for a, b in zip(got, (w, pixel, light)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

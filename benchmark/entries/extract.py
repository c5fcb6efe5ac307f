"""Transport-graph extraction, the reference's createGraph: one job is
render/inverse.py extract_graph of one observed image under its own key,
the graph synchronised on the device.  Observed images are drawn from the
seed on the device (a pool of `images`, one per job in turn); the
extraction's work does not depend on their values.

The check compares the graphs (w, pixel, light) of a sample of the
window's jobs, drawn from the seed, with the reference's: the gap of w
(the summed absolute gap over the summed w, i.e. the mean over visited
rows of a row's L1 gap, as each row sums to 1), and the gaps of the pixel
and light features weighted by the reference's count of edges in each bin
(a bin that one path visits moves with that path alone, and would weigh as
much as a busy one under w); and the shadow rays of those jobs (the program's counted by
trace_transport_range, outside the timed jobs)."""

from __future__ import annotations

import torch

from benchmark.lib import floors, program
from benchmark.reference import rng as rr
from benchmark.reference import tracer

WARM_TAG = 0xFFFFFFFF


class State:
    pass


def setup(ctx):
    st, t = State(), ctx.traffic
    st.t, st.ctx, st.device = t, ctx, ctx.device
    st.cfg = program.render_config(ctx.config, t)
    st.scene = program.build_scene(ctx.config, ctx.gen_dir).to(ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    st.images = torch.rand((t["images"], t["height"], t["width"], 3), generator=gen,
                           device=ctx.device)
    st.key = program.base_key(ctx.seed)
    st.kept = program.Reservoir(t["check_jobs"], ctx.seed)
    for w in range(t.get("warmup_jobs", 1)):
        _extract(st, rr.fold_in(st.key, WARM_TAG - w), st.images[0])
    return st


def _extract(st, key, image):
    from inverse_path_tracer_torch.render import inverse

    graph = inverse.extract_graph(st.scene, image, key, st.cfg, device=st.device)
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    return graph


def _image(st, i):
    return st.images[i % st.images.shape[0]]


def paths_per_job(st) -> int:
    return st.cfg.n_samples


def job(st, i):
    return _extract(st, rr.fold_in(st.key, i), _image(st, i))


def collect(st, i, result):
    st.kept.offer(lambda: (i, [g.detach().cpu() for g in result]))


def after_window(st):
    """The program's shadow rays of each kept job (trace_transport_range,
    outside the timed jobs), then its state is freed."""
    from inverse_path_tracer_torch.render import inverse

    hits = []
    for i, _ in st.kept.items:
        _, s = inverse.trace_transport_range(st.scene, _image(st, i), rr.fold_in(st.key, i),
                                             st.cfg, 0, st.cfg.n_samples, device=st.device)
        hits.append(int(s.shadow_rays))
    st.out = dict(graphs=[g for _, g in st.kept.items], hits=hits)
    nt = st.scene.n_tri
    st.least = dict(hits=sum(hits) / max(len(hits), 1),
                    bytes=st.t["width"] * st.t["height"] * 12 + (nt + 1) * nt * 7 * 4
                    + floors.scene_bytes(nt, st.scene.has_vertex_normals))
    del st.scene


def reference_outputs(st, dt):
    sc = tracer.on(program.reference_scene(st.ctx.config, st.ctx.gen_dir), st.device, dt)
    t, graphs, counts, hits = st.t, [], [], []
    for i, _ in st.kept.items:
        g, n, h = tracer.extract(sc, _image(st, i).reshape(-1, 3), rr.fold_in(st.key, i), t["width"],
                              t["height"], t["spp"], st.cfg.max_bounces, st.cfg.p_rr,
                              t.get("ref_samples_per_chunk", 1 << 21))
        graphs.append([x.float().cpu() for x in g])
        counts.append(n.float().cpu())
        hits.append(h)
    return dict(graphs=graphs, counts=counts, hits=hits)


def judge(st, out, ref):
    w_gap = pix_gap = light_gap = 0.0
    for (wp, pp, lp), (wr, pr, lr), n in zip(out["graphs"], ref["graphs"], ref["counts"]):
        n = n[..., None]
        w_gap = max(w_gap, float((wp - wr).abs().sum() / wr.sum()))
        pix_gap = max(pix_gap, float(((pp - pr).abs() * n).sum() / (3 * n.sum())))
        light_gap = max(light_gap, float(((lp - lr).abs() * n).sum() / (lr.abs() * n).sum()))
    hp, hr = sum(out["hits"]), sum(ref["hits"])
    return {"w_gap": w_gap, "pixel_gap": pix_gap, "light_gap": light_gap,
            "hits_gap": abs(hp - hr) / max(hr, 1)}

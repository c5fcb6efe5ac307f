"""Faults planted in the timed path, to show that the check catches them
(benchmark/tests/test_bench_faults.py on the CPU, control.py --fault on the
card).  Each is a context manager that replaces one function of the
program for the duration of a run and restores it after."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def state_unchanged():
    """Recovery: the step computes its losses but never moves theta."""
    from inverse_path_tracer_torch.models import recover

    def make(orig):
        def step(theta, opt, *a, **kw):
            with torch.no_grad():
                keep = theta.detach().clone()
            out = orig(theta, opt, *a, **kw)
            with torch.no_grad():
                theta.copy_(keep)
            return out
        return step
    return _patched(recover, "batched_step", make)


def half_batch():
    """Recovery: only the first half of the scenes are rendered and
    stepped; the losses of the rest are the mean of the first half's."""
    from inverse_path_tracer_torch.models import recover

    def make(orig):
        def step(theta, opt, scene, keys, cfg, targets01, n_keys=1, scene_chunk=0, **kw):
            h = theta.shape[0] // 2
            opt.zero_grad(set_to_none=True)
            part = [recover.keyed_loss(theta[j], scene, keys[j], cfg, targets01[j], n_keys, **kw)
                    for j in range(h)]
            torch.stack(part).sum().backward()
            opt.step()
            losses = torch.stack(part).detach()
            return torch.cat([losses, losses.mean().expand(theta.shape[0] - h)])
        return step
    return _patched(recover, "batched_step", make)


def altered_radiance(scale: float = 1.01):
    """Render: every sample's radiance comes back scaled by `scale`."""
    from inverse_path_tracer_torch.render import forward

    def make(orig):
        def render(*a, **kw):
            vals, stats = orig(*a, **kw)
            return vals * scale, stats
        return render
    return _patched(forward, "render_samples", make)


def half_samples():
    """Render: the second half of the samples come back as zeros."""
    from inverse_path_tracer_torch.render import forward

    def make(orig):
        def render(*a, **kw):
            vals, stats = orig(*a, **kw)
            vals = vals.clone()
            vals[vals.shape[0] // 2:] = 0
            return vals, stats
        return render
    return _patched(forward, "render_samples", make)


def half_paths():
    """Extraction: the graph of the first half of the samples only."""
    from inverse_path_tracer_torch.render import inverse

    def make(orig):
        def extract(scene, image, key, cfg, **kw):
            grids, _ = inverse.trace_transport_range(scene, image, key, cfg, 0,
                                                     cfg.n_samples // 2, **kw)
            return inverse.compress_grids(grids, scene.n_tri)
        return extract
    return _patched(inverse, "extract_graph", make)


def altered_graph(scale: float = 1.01):
    """Extraction: the pixel features come back scaled by `scale`."""
    from inverse_path_tracer_torch.render import inverse

    def make(orig):
        def extract(*a, **kw):
            w, pixel, light = orig(*a, **kw)
            return w, pixel * scale, light
        return extract
    return _patched(inverse, "extract_graph", make)


BY_ENTRY = {
    "recover": {"state_unchanged": state_unchanged, "half_batch": half_batch},
    "render": {"altered_radiance": altered_radiance, "half_samples": half_samples},
    "extract": {"half_paths": half_paths, "altered_graph": altered_graph},
}

"""Device ms per job of B2's BVH instances (render_bwd.cu
grad_tile_kernel<..., 2>, the sweep argument render_common.cuh's
kSweepBvh): the mega gradient on the BVH route, which replays each path
with `traverse` (render/forward.py _grad_launches)."""

from benchmark.lib.trace import short, symbol

BVH_SWEEP = "2"  # render_common.cuh kSweepBvh, the last template argument


def read(s):
    t = sum(e - a for n, a, e in s.device_ops
            if symbol(n) == "grad_tile_kernel" and short(n).rstrip(">").split(",")[-1].strip()
            == BVH_SWEEP)
    return t / s.n_jobs * 1e3 if t > 0 and s.n_jobs else None

"""Device ms per job of the record-writing B8 instances
(render_fwd.cu stage_kernel<true, ...>): the replay of the staged forward
that the staged gradient runs before B9 (render/forward.py _replay)."""

from benchmark.lib.trace import short, symbol


def read(s):
    t = sum(e - a for n, a, e in s.device_ops
            if symbol(n) == "stage_kernel" and short(n).startswith("stage_kernel<true"))
    return t / s.n_jobs * 1e3 if t > 0 and s.n_jobs else None

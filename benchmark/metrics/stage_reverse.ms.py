"""Device ms per job of B9 (render_bwd.cu stage_reverse_kernel), the
staged gradient's recursion over each stage's records."""

from benchmark.lib.trace import symbol


def read(s):
    t = sum(e - a for n, a, e in s.device_ops if symbol(n) == "stage_reverse_kernel")
    return t / s.n_jobs * 1e3 if t > 0 and s.n_jobs else None

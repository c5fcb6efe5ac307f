"""Device ms per render of PyTorch's own operations in the forward path:
the staged wavefront's sorts and gathers, the tonemap, copies and fills;
every device operation that is not one of the program's kernels."""


def read(s):
    return s.torch_s() / s.n_jobs * 1e3 if s.entry == "render" and s.n_jobs else None

"""Device ms per extraction of PyTorch's own operations: the float64 grid's
fill and casts, unperm_grid and compress_grids; every device operation
that is not one of the program's kernels."""


def read(s):
    return s.torch_s() / s.n_jobs * 1e3 if s.entry == "extract" and s.n_jobs else None

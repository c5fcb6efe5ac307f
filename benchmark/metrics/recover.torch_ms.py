"""Device ms per recovery step of PyTorch's own operations (sigmoid,
tonemap and its backward, the L1 loss, Adam, copies and fills): every
device operation of the traced steps that is not one of the program's
kernels (benchmark/kernels/*.txt)."""


def read(s):
    return s.torch_s() / s.n_jobs * 1e3 if s.entry == "recover" and s.n_jobs else None

"""Device ms per job of the program's own kernels, recognised by symbol
name from benchmark/kernels/<source>.txt."""


def read(s):
    t = s.port_s()
    return t / s.n_jobs * 1e3 if t > 0 and s.n_jobs else None

"""The program's kernels' share of their roofline: a job's least time
(benchmark/lib/floors.py: hits and bytes that any implementation needs,
over the H100's published peaks) divided by its kernels' device time."""


def read(s):
    t = s.port_s()
    if t <= 0 or not s.n_jobs or not s.least_s_per_job:
        return None
    return 100.0 * s.least_s_per_job / (t / s.n_jobs)

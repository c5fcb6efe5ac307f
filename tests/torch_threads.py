"""Torch's intra-op CPU threads in the test processes.

Under pytest-xdist each of the PYTEST_XDIST_WORKER_COUNT workers gets
os.cpu_count() // workers threads (at least 1), so that the workers' torch
pools together do not oversubscribe the cores; outside xdist torch keeps
its default.  Every tests/test_torch_*.py imports this module first among
the port's imports.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 0:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))

"""Profiling hooks (the counterpart of the JAX package's utils/profiling.py).

profile_trace(log_dir) records a torch.profiler trace of the enclosed block
(CPU and, where there is a card, CUDA activities) and writes it as a Chrome
trace file under log_dir; StageTimer sums named wall-clock stages, each
ending in a synchronisation of the device of the tensor it is given.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the enclosed block into log_dir/trace_<pid>_<ns>.json (open it
    in chrome://tracing or Perfetto) when log_dir is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Named wall-clock stages with device synchronization."""

    def __init__(self):
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: Optional[torch.Tensor] = None):
        """Add the block's wall time to stages[name]; with `sync` (a tensor)
        the clock is read after its device has finished its queued work."""
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

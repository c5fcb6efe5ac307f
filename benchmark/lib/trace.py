"""Reduction of a torch.profiler trace of whole jobs to what the per-layer
readers, busy_s, window_s and the breakdown read.  The trace stays in
memory: events are read from the profiler's result, not from a file."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

JOB_SPAN = "bench.job"


def symbol(name: str) -> str:
    """The bare identifier of a demangled kernel name: 'void
    render_kernel<false, 0>(TraceParams, float*)' -> 'render_kernel'."""
    s = re.sub(r"^(void|__global__)\s+", "", name.strip()).replace("(anonymous namespace)", "")
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.split("::")[-1].strip()


def short(name: str) -> str:
    """A kernel's name without its parameter list."""
    s = re.sub(r"^void\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:200]


def _annotation(e) -> bool:
    """A span of the host's record_function mirrored on the device's
    timeline: no device operation."""
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Summary:
    """Device operations (name, start, end in seconds) inside the traced
    window, the host's operations, the window, and the job count; plus
    what the readers need about the cell (entry, least work per job).

    The traced window is the union of the jobs' spans: each job ends with
    its result on the host, so its device work lies inside its span, and
    what the harness does between jobs is left out."""

    def __init__(self, device_ops, host_ops, jobs: List[Tuple[float, float]],
                 entry: str, least_s_per_job: Optional[float], port_kernels: Dict[str, List[str]]):
        self.jobs = merge(jobs)
        self.device_ops = [(n, max(s, a), min(e, b)) for n, s, e in device_ops
                           for a, b in self.jobs if e > a and s < b]
        self.host_ops = host_ops
        self.n_jobs = len(jobs)
        self.entry = entry
        self.least_s_per_job = least_s_per_job
        self.port_symbols = {k for names in port_kernels.values() for k in names}

    @classmethod
    def from_profiler(cls, prof, **kw) -> "Summary":
        dev, host, jobs = [], [], []
        for e in prof.profiler.kineto_results.events():
            s, t = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
            if str(e.device_type()).endswith("CUDA"):  # kernels, copies and fills
                if e.name() != JOB_SPAN and not _annotation(e):
                    dev.append((e.name(), s, t))
            elif e.name() == JOB_SPAN:
                jobs.append((s, t))
            else:
                host.append((e.name(), s, t))
        if not jobs:
            raise RuntimeError("the trace holds no job span")
        return cls(dev, host, jobs, **kw)

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.jobs)

    def busy(self) -> List[Tuple[float, float]]:
        return merge([(s, e) for _, s, e in self.device_ops])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def is_port(self, name: str) -> bool:
        return symbol(name) in self.port_symbols

    def port_s(self) -> float:
        return sum(e - s for n, s, e in self.device_ops if self.is_port(n))

    def torch_s(self) -> float:
        """Device time of every operation that is not one of the program's
        own kernels: PyTorch's kernels, copies and fills."""
        return sum(e - s for n, s, e in self.device_ops if not self.is_port(n))

    def device_ops_top(self, k: int = 10) -> List[list]:
        by = defaultdict(float)
        for n, s, e in self.device_ops:
            by[short(n)] += e - s
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps_top(self, k: int = 10) -> List[list]:
        """The longest stretches of the window in which no device
        operation ran, each named by the innermost host operation that was
        running at its middle."""
        busy, gaps = self.busy(), []
        for a, b in self.jobs:
            inside = [iv for iv in busy if iv[1] > a and iv[0] < b]
            edges = [a] + [x for iv in inside for x in iv] + [b]
            gaps += [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for s, e in gaps[:k]:
            mid = (s + e) / 2
            best = None
            for n, hs, he in host[:bisect.bisect_right(starts, mid)][-4000:]:
                if he >= mid and (best is None or he - hs < best[1]):
                    best = (n, he - hs)
            out.append([best[0] if best else "(no host op)", e - s])
        return out

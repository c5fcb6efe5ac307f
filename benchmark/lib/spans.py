"""The card's idle time charged to the program's spans.

The program marks its host work with spans named ipt.<layer>.<what>
(inverse_path_tracer_torch/utils/profiling.py span), which a traced run
records on the kernels' timeline.  An idle instant is a moment inside a
job span at which no device operation runs (Summary.busy).  Each idle
instant is charged to the innermost, that is the shortest, ipt.* span
open at that instant on any thread (autograd's backward runs on a thread
of its own); idle under no ipt.* span stays unattributed.  So the layers'
charges and the unattributed idle sum to the window less the busy time.

Works only on what Summary holds: host_ops, jobs, busy() and n_jobs."""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

# The metrics' layers, by span name prefix.
LAYERS = {
    "prep": ("ipt.prep.",),
    "launch": ("ipt.launch.",),
    "forward": ("ipt.render.", "ipt.staged."),
    "recover": ("ipt.recover.",),
    "extract": ("ipt.extract.",),
}
UNATTRIBUTED = "unattributed"


def layer_of(name: str) -> Optional[str]:
    for layer, prefixes in LAYERS.items():
        if name.startswith(prefixes):
            return layer
    return None


def program_spans(s) -> List[Tuple[str, float, float]]:
    """The host's ipt.* spans of a known layer that overlap a job."""
    return [(n, a, b) for n, a, b in s.host_ops
            if b > a and layer_of(n) and any(b > ja and a < jb for ja, jb in s.jobs)]


def idle_gaps(s) -> List[Tuple[float, float]]:
    """The jobs' stretches in which no device operation runs."""
    busy, gaps = s.busy(), []
    for a, b in s.jobs:
        t = a
        for bs, be in busy:
            if be <= t or bs >= b:
                continue
            if bs > t:
                gaps.append((t, bs))
            t = max(t, be)
        if t < b:
            gaps.append((t, b))
    return gaps


def charged(s) -> Dict[str, float]:
    """Idle seconds of the traced jobs by layer, and UNATTRIBUTED."""
    out = dict.fromkeys(list(LAYERS) + [UNATTRIBUTED], 0.0)
    spans = program_spans(s)
    # (time, kind, index): kind 0 opens and 1 closes a gap, 2 opens and 3
    # closes span `index`.
    events = [(t, k, -1) for a, b in idle_gaps(s) for t, k in ((a, 0), (b, 1))]
    events += [(t, k, i) for i, (_, a, b) in enumerate(spans) for t, k in ((a, 2), (b, 3))]
    events.sort()
    open_spans: List[Tuple[float, int]] = []  # heap of (length, index)
    closed = set()
    idle, prev = False, None
    for t, kind, i in events:
        if idle and t > prev:
            while open_spans and open_spans[0][1] in closed:
                heapq.heappop(open_spans)
            layer = layer_of(spans[open_spans[0][1]][0]) if open_spans else UNATTRIBUTED
            out[layer] += t - prev
        prev = t
        if kind < 2:
            idle = kind == 0
        elif kind == 2:
            heapq.heappush(open_spans, (spans[i][2] - spans[i][1], i))
        else:
            closed.add(i)
    return out


def idle_ms(s, layer: str) -> Optional[float]:
    """Idle ms per job charged to `layer`'s spans; None where the trace
    holds no span of the layer (a program without them, or a cell that
    does not run the layer)."""
    if not s.n_jobs or not any(layer_of(n) == layer for n, _, _ in program_spans(s)):
        return None
    return charged(s)[layer] / s.n_jobs * 1e3

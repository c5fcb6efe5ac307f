"""B2's BVH instance's share of its roofline: its least time a job over
grad_bvh.ms.

The least time is the larger of 13 float32 operations per replayed hit
over 67 TFLOP/s and the least bytes over 3.35 TB/s
(benchmark/lib/floors.py).  The replayed hits are the segments and shadow
rays of the forward that B2 traces again (the program's counter
ipt.grad.replayed); the bytes are each lane's cotangent g (3 float32) read
once and the (nT, 3) float32 gradient written once a launch (the counters
ipt.grad.lanes and ipt.grad.rows).  The counters are read from the traced
run's marks; a program without them, or a run with no BVH instance of B2,
reads nothing."""

from benchmark.lib import floors
from benchmark.lib.manifest import metric_reader

LANE_BYTES = 3 * 4
ROW_BYTES = 3 * 4
COUNTERS = ("ipt.grad.replayed", "ipt.grad.lanes", "ipt.grad.rows")


def least_seconds(replayed: int, lanes: int, rows: int) -> float:
    return floors.least_seconds(replayed, LANE_BYTES * lanes + ROW_BYTES * rows)


def read(s):
    ms = metric_reader("grad_bvh.ms").read(s)
    c = metric_reader("stage_reverse_roofline").counts(s)
    if not ms or not all(k in c for k in COUNTERS):
        return None
    least = least_seconds(*(c[k] for k in COUNTERS))
    return 100.0 * least / s.n_jobs / (ms * 1e-3)

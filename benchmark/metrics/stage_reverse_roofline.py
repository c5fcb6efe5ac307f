"""B9's share of its roofline: its least time a job over stage_reverse.ms.

The least time is B9's least bytes over the H100's 3.35 TB/s
(benchmark/lib/floors.py): each record slot the replay reached (64 B,
render/diff.py's 16 float32 rows of a bounce) read once, and per lane of
each B9 launch the cotangent g (3 float32) read once and the (suf, esc)
carry (4 float32) read once and written once.  The slots and the lanes are
the program's counters ipt.staged.records and ipt.staged.reverse_lanes
(utils/profiling.py count), read from the traced run's marks; a program
without them, or a run with no B9, reads nothing."""

from benchmark.lib import floors
from benchmark.lib.manifest import metric_reader

RECORD_BYTES = 16 * 4
LANE_BYTES = (3 + 4 + 4) * 4


def least_bytes(records: int, lanes: int) -> int:
    return RECORD_BYTES * records + LANE_BYTES * lanes


def counts(s) -> dict:
    """{counter: sum} of the program's count marks among the host
    operations inside the traced jobs; {} where the program has no
    counter."""
    try:
        from inverse_path_tracer_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "counted", None)
    if read is None:
        return {}
    return read(n for n, a, b in s.host_ops if any(b > ja and a < jb for ja, jb in s.jobs))


def read(s):
    ms = metric_reader("stage_reverse.ms").read(s)
    c = counts(s)
    if not ms or "ipt.staged.records" not in c or "ipt.staged.reverse_lanes" not in c:
        return None
    nbytes = least_bytes(c["ipt.staged.records"], c["ipt.staged.reverse_lanes"])
    return 100.0 * nbytes / floors.PEAK_BYTES / s.n_jobs / (ms * 1e-3)

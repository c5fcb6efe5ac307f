"""Idle ms per job of the card charged to the program's preparation spans
(ipt.prep.*): the Morton order sorted on the host (clusters.kernel_perm),
the kernels' tables (render_kernel.pack_tables), the binning box
(forward._scene_bins) and the extraction's float64 grid.  The rule is
benchmark/lib/spans.py's."""

from benchmark.lib.spans import idle_ms


def read(s):
    return idle_ms(s, "prep")

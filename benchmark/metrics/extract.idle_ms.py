"""Idle ms per job of the card charged to the extraction's spans
(ipt.extract.*): render/inverse.py's range, its finish (unperm_grid,
grids_from_acc) and compress_grids, outside the nested preparation and
launch spans.  The rule is benchmark/lib/spans.py's."""

from benchmark.lib.spans import idle_ms


def read(s):
    return idle_ms(s, "extract")

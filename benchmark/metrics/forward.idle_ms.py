"""Idle ms per job of the card charged to the render's spans (ipt.render.*,
ipt.staged.*): render/forward.py's ranges forward and backward and the
staged wavefront's re-sorts and gathers between stages, outside the
nested preparation and launch spans.  The rule is benchmark/lib/spans.py's."""

from benchmark.lib.spans import idle_ms


def read(s):
    return idle_ms(s, "forward")

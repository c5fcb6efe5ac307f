"""Idle ms per job of the card charged to the recovery's spans
(ipt.recover.*): models/recover.py's step, loss, backward calls and Adam,
outside the nested render spans.  The rule is benchmark/lib/spans.py's."""

from benchmark.lib.spans import idle_ms


def read(s):
    return idle_ms(s, "recover")
